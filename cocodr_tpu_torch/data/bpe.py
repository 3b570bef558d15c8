"""Byte-level BPE, GPT-2's, which RoBERTa checkpoints carry in `vocab.json`
+ `merges.txt`: the port's counterpart of the two `tokenizers` components
a `RobertaTokenizerFast` runs between its added-token split and its
post-processor, without importing tokenizers, transformers or regex.

  1. pre-tokenization (`ByteLevel`): with add_prefix_space, a space put
     before a text that does not start with one; the text cut by GPT-2's
     pattern
       's|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+
       |\\s+(?!\\S)|\\s+
     (the contractions are case-sensitive, and a whitespace run before a
     word leaves its last space to prefix the word); each piece's UTF-8
     bytes then mapped to printable characters (`bytes_to_unicode`);
  2. `BPE`: a piece's characters merged pair by pair, the pair of lowest
     rank in merges.txt first and the leftmost of equal ranks, as the fast
     tokenizer's priority queue orders them; each word's ids kept in a
     cache, since a corpus repeats its words.

Python's `re` has no \\p{L} or \\p{N}, and the `regex` package is not a
dependency of the port: the pattern's classes are written out as ranges of
code points from unicodedata's categories (L* letters, N* numbers) and
Unicode's White_Space property (what the fast tokenizer's \\s matches),
built once a process at first use (~0.3 s). A character that Python's
Unicode database does not assign yet falls in the third class, where a
newer database may call it a letter or a number.
"""
from __future__ import annotations

import functools
import json
import re
import sys
import unicodedata
from typing import Dict, List, Optional, Sequence, Tuple

from cocodr_tpu_torch.data.tokenizer import WHITE_SPACE

# words whose ids the cache keeps; later words are merged each time
CACHE_WORDS = 1 << 18


def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's map of the 256 byte values to printable characters: the
    printable Latin-1 bytes map to themselves, the others to 256.. in
    order (a space becomes 'Ġ', a newline 'Ċ')."""
    keep = (list(range(ord("!"), ord("~") + 1))
            + list(range(ord("¡"), ord("¬") + 1))
            + list(range(ord("®"), ord("ÿ") + 1)))
    out, extra = {}, 0
    for b in range(256):
        if b in keep:
            out[b] = chr(b)
        else:
            out[b] = chr(256 + extra)
            extra += 1
    return out


# str.translate table from a byte's Latin-1 character to its symbol
_BYTE_TABLE = {b: ch for b, ch in bytes_to_unicode().items()}


def _char_class(cps: Sequence[int]) -> str:
    """Sorted code points -> the body of a re character class."""
    out, i = [], 0
    while i < len(cps):
        j = i
        while j + 1 < len(cps) and cps[j + 1] == cps[j] + 1:
            j += 1
        out.append(f"\\U{cps[i]:08x}" if i == j
                   else f"\\U{cps[i]:08x}-\\U{cps[j]:08x}")
        i = j + 1
    return "".join(out)


@functools.lru_cache(maxsize=None)
def split_pattern() -> "re.Pattern":
    """GPT-2's split pattern with \\p{L}, \\p{N} and \\s written out."""
    letters, numbers = [], []
    for cp in range(sys.maxunicode + 1):
        major = unicodedata.category(chr(cp))[0]
        if major == "L":
            letters.append(cp)
        elif major == "N":
            numbers.append(cp)
    L, N = _char_class(letters), _char_class(numbers)
    S = _char_class(sorted(map(ord, WHITE_SPACE)))
    return re.compile(
        rf"'s|'t|'re|'ve|'m|'ll|'d| ?[{L}]+| ?[{N}]+| ?[^{S}{L}{N}]+"
        rf"|[{S}]+(?![^{S}])|[{S}]+")


class ByteLevel:
    """The ByteLevel pre-tokenizer: text -> its pieces in byte symbols."""

    def __init__(self, add_prefix_space: bool = False,
                 use_regex: bool = True):
        self.add_prefix_space = add_prefix_space
        self.use_regex = use_regex

    def __call__(self, text: str) -> List[str]:
        if self.add_prefix_space and not text.startswith(" "):
            text = " " + text
        pieces = split_pattern().findall(text) if self.use_regex else [text]
        return [p.encode("utf-8").decode("latin-1").translate(_BYTE_TABLE)
                for p in pieces]


class BPE:
    """The BPE model over a vocabulary (token -> id) and merges in rank
    order. A character outside the vocabulary becomes unk_token (runs of
    them one unk_token with fuse_unk), or is dropped when there is none;
    with ignore_merges a word found whole in the vocabulary is its own
    token."""

    def __init__(self, vocab: Dict[str, int],
                 merges: Sequence[Tuple[str, str]],
                 unk_token: Optional[str] = None, fuse_unk: bool = False,
                 ignore_merges: bool = False):
        self.vocab = dict(vocab)
        # a pair listed twice takes its later rank, as in tokenizers
        self.ranks = {pair: i for i, pair in enumerate(merges)}
        for a, b in self.ranks:
            for tok in (a, b, a + b):
                if tok not in self.vocab:
                    raise ValueError(f"merge ({a!r}, {b!r}): {tok!r} is "
                                     "not in the vocabulary")
        if unk_token is not None and unk_token not in self.vocab:
            raise ValueError(f"unk_token {unk_token!r} is not in the "
                             "vocabulary")
        self.unk_token = unk_token
        self.fuse_unk = fuse_unk
        self.ignore_merges = ignore_merges
        self._cache: Dict[str, List[int]] = {}

    def _symbols(self, word: str) -> List[str]:
        if all(ch in self.vocab for ch in word):
            return list(word)
        syms, unk_run = [], False
        for ch in word:
            if ch in self.vocab:
                syms.append(ch)
                unk_run = False
            elif self.unk_token is not None:
                if not (unk_run and self.fuse_unk):
                    syms.append(self.unk_token)
                unk_run = True
        return syms

    def _merge(self, word: str) -> List[int]:
        if self.ignore_merges and word in self.vocab:
            return [self.vocab[word]]
        syms = self._symbols(word)
        ranks, never = self.ranks, len(self.ranks)
        pair_rank = [ranks.get(p, never) for p in zip(syms, syms[1:])]
        while pair_rank:
            best = min(pair_rank)
            if best == never:
                break
            i = pair_rank.index(best)
            syms[i:i + 2] = [syms[i] + syms[i + 1]]
            del pair_rank[i]
            if i < len(pair_rank):
                pair_rank[i] = ranks.get((syms[i], syms[i + 1]), never)
            if i:
                pair_rank[i - 1] = ranks.get((syms[i - 1], syms[i]), never)
        return [self.vocab[s] for s in syms]

    def tokenize(self, word: str) -> List[int]:
        ids = self._cache.get(word)
        if ids is None:
            ids = self._merge(word)
            if len(self._cache) < CACHE_WORDS:
                self._cache[word] = ids
        return ids


def read_vocab_merges(vocab_path: str, merges_path: str
                      ) -> Tuple[Dict[str, int], List[Tuple[str, str]]]:
    """vocab.json and merges.txt as transformers' RobertaTokenizer reads
    them: the merges file's first line (its '#version' header) and the
    text after its last newline are skipped, each other line is a pair
    split on whitespace, and a pair listed twice keeps its first place."""
    with open(vocab_path, encoding="utf-8") as f:
        vocab = json.load(f)
    with open(merges_path, encoding="utf-8") as f:
        lines = f.read().split("\n")[1:-1]
    merges = [tuple(line.split()) for line in lines]
    for n, pair in enumerate(merges):
        if len(pair) != 2:
            raise ValueError(f"{merges_path}: line {n + 2} is not a pair: "
                             f"{lines[n]!r}")
    return vocab, list(dict.fromkeys(merges))
