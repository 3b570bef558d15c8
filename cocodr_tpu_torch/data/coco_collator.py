"""COCO (coCondenser) data plane: whole-word-mask collation of span pairs.
The port's copy of cocodr_tpu/data/coco_collator.py (pure Python and
numpy), so that the same seed gives the same arrays in both packages.

Rebuild of reference COCO/data.py:24-182 with numpy batches:
- BERT whole-word candidate merging ('##' continuations), shuffled greedy
  selection of ~mlm_probability of tokens (data.py:68-99);
- random-offset truncation for overlong spans (data.py:101-116), applied
  once per example (the reference calls _truncate twice with an advancing
  RNG, so its mask positions can desync from the encoded window; this
  keeps the coherent behaviour);
- 80/10/10 [MASK]/random/keep corruption with labels=-100 off-mask
  (HuggingFace torch_mask_tokens semantics);
- two spans per document, duplicated when only one exists (data.py:177-182),
  flattened consecutively so that pairs stay adjacent for the flipped-pair
  contrastive targets.

The tokenizer is duck-typed: `all_special_tokens`, `mask_token_id`,
`vocab_size`, `cls_token_id`, `sep_token_id`, `pad_token_id`,
`convert_ids_to_tokens` and `num_special_tokens_to_add`.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Dict, List, Sequence

import numpy as np

IGNORE_INDEX = -100


@dataclasses.dataclass
class CondenserWWMCollator:
    tokenizer: object
    mlm_probability: float = 0.15
    max_seq_length: int = 128
    seed: int = 0

    def __post_init__(self):
        self._rng = random.Random(self.seed)
        self.specials = set(self.tokenizer.all_special_tokens)
        self.mask_id = self.tokenizer.mask_token_id
        self.vocab_size = self.tokenizer.vocab_size

    def reseed(self, batch_index: int):
        """Key the mask and truncation randomness on (seed, batch_index),
        as the per-step dropout generators are keyed on the step. A
        resumed run can then skip the collation of batches already
        consumed and still draw batch N's masks as an uninterrupted run
        does (a sequential stream would desync; the reference pays a
        collate-and-discard pass per skipped batch under the HuggingFace
        Trainer instead)."""
        self._rng = random.Random(f"{self.seed}:{batch_index}")

    def _whole_word_cand_indexes(self, tokens: List[str]) -> List[List[int]]:
        cand: List[List[int]] = []
        for i, tok in enumerate(tokens):
            if tok in self.specials:
                continue
            if cand and tok.startswith("##"):
                cand[-1].append(i)
            else:
                cand.append([i])
        return cand

    def _whole_word_mask(self, tokens: List[str], max_predictions=512):
        cand = self._whole_word_cand_indexes(tokens)
        self._rng.shuffle(cand)
        num_to_predict = min(
            max_predictions,
            max(1, int(round(len(tokens) * self.mlm_probability))),
        )
        covered = set()
        masked = 0
        for index_set in cand:
            if masked >= num_to_predict:
                break
            if masked + len(index_set) > num_to_predict:
                continue
            if any(i in covered for i in index_set):
                continue
            covered.update(index_set)
            masked += len(index_set)
        return [1 if i in covered else 0 for i in range(len(tokens))]

    def _truncate(self, ids: List[int]) -> List[int]:
        tgt = self.max_seq_length - self.tokenizer.num_special_tokens_to_add(
            False
        )
        if len(ids) <= tgt:
            return ids
        trunc = len(ids) - tgt
        left = self._rng.randint(0, trunc)
        right = trunc - left
        out = ids[left:]
        if right:
            out = out[:-right]
        return out

    def _corrupt(self, input_ids: np.ndarray, mlm_mask: np.ndarray):
        """HF torch_mask_tokens: 80% [MASK], 10% random, 10% keep."""
        labels = np.where(mlm_mask == 1, input_ids, IGNORE_INDEX)
        probs = np.asarray(
            [self._rng.random() for _ in range(input_ids.size)]
        ).reshape(input_ids.shape)
        do_mask = (mlm_mask == 1) & (probs < 0.8)
        do_random = (mlm_mask == 1) & (probs >= 0.8) & (probs < 0.9)
        out = input_ids.copy()
        out[do_mask] = self.mask_id
        n_rand = int(do_random.sum())
        if n_rand:
            out[do_random] = np.asarray(
                [self._rng.randrange(self.vocab_size) for _ in range(n_rand)]
            )
        return out, labels

    def __call__(self, examples: Sequence[Dict]) -> Dict[str, np.ndarray]:
        """examples: [{'text': [token ids]}] -> batch arrays."""
        L = self.max_seq_length
        batch_ids, batch_mask, batch_mlm = [], [], []
        cls_id = self.tokenizer.cls_token_id
        sep_id = self.tokenizer.sep_token_id
        pad_id = self.tokenizer.pad_token_id
        for e in examples:
            ids = self._truncate(list(e["text"]))
            tokens = self.tokenizer.convert_ids_to_tokens(ids)
            mlm = [0] + self._whole_word_mask(tokens) + [0]
            framed = [cls_id] + ids + [sep_id]
            attn = [1] * len(framed)
            pad = L - len(framed)
            batch_ids.append(framed + [pad_id] * pad)
            batch_mask.append(attn + [0] * pad)
            batch_mlm.append((mlm + [0] * pad)[:L])
        input_ids = np.asarray(batch_ids, np.int32)
        mlm_mask = np.asarray(batch_mlm, np.int32)
        corrupted, labels = self._corrupt(input_ids, mlm_mask)
        return {
            "input_ids": corrupted.astype(np.int32),
            "attention_mask": np.asarray(batch_mask, np.int32),
            "labels": labels.astype(np.int32),
        }


@dataclasses.dataclass
class CoCondenserCollator(CondenserWWMCollator):
    """Flatten 2 spans/doc into consecutive batch rows (data.py:161-166)."""

    def collate_spans(self, docs: Sequence[Dict]) -> Dict[str, np.ndarray]:
        flat = []
        for d in docs:
            spans = d["spans"]
            pair = spans + spans if len(spans) == 1 else self._rng.sample(
                list(spans), 2
            )
            flat.extend({"text": s} for s in pair)
        return self(flat)


def greedy_pack_spans(
    sentences_tokens: List[List[int]],
    target_len: int = 30,
    break_prob: float = 0.1,
    rng: random.Random = None,
) -> List[List[int]]:
    """Greedy-pack tokenized sentences into ~target_len spans with a random
    break (reference COCO/helper/create_train_co_short.py:34-72)."""
    rng = rng or random.Random(0)
    spans, cur = [], []
    for sent in sentences_tokens:
        if cur and (
            len(cur) + len(sent) > target_len or rng.random() < break_prob
        ):
            spans.append(cur)
            cur = []
        cur = cur + list(sent)
    if cur:
        spans.append(cur)
    return spans
