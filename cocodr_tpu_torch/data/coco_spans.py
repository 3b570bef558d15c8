"""COCO span-corpus preprocessing: documents -> tokenized sentence spans.
The port's copy of cocodr_tpu/data/coco_spans.py (pure Python).

Rebuild of reference COCO/helper/create_train_co_short.py:34-85 + the
18-corpus loop (COCO/pre_processing_coco.sh:6-16): sentence-split each
document, tokenize sentences, greedy-pack into ~target_len-token spans with
a random break probability, and emit JSON lines {"spans": [[ids...], ...]}.

Sentence splitting uses NLTK punkt when available, else a regex fallback
(offline tooling; never in the training hot path).
"""
from __future__ import annotations

import json
import random
import re
from typing import Iterable, Iterator, List, Optional

from cocodr_tpu_torch.data.coco_collator import greedy_pack_spans

# The 18 BEIR target corpora of COCO pretraining
# (reference COCO/pre_processing_coco.sh:6).
COCO_CORPORA = (
    "trec-covid",
    "nfcorpus",
    "nq",
    "hotpotqa",
    "fiqa",
    "arguana",
    "webis-touche2020",
    "quora",
    "dbpedia-entity",
    "scidocs",
    "fever",
    "climate-fever",
    "scifact",
    "cqadupstack",
    "trec-news",
    "robust04",
    "signal1m",
    "bioasq",
)

_SENT_RE = re.compile(r"(?<=[.!?])\s+")


def split_sentences(text: str) -> List[str]:
    try:
        import nltk

        try:
            return nltk.sent_tokenize(text)
        except LookupError:
            pass
    except ImportError:
        pass
    return [s for s in _SENT_RE.split(text) if s.strip()]


def doc_to_spans(
    text: str,
    tokenizer,
    target_len: int = 30,
    break_prob: float = 0.1,
    rng: Optional[random.Random] = None,
    max_sentence_tokens: int = 512,
) -> List[List[int]]:
    """One document -> list of token-id spans (create_train_co_short
    `encode_one` semantics)."""
    rng = rng or random.Random(0)
    sents = []
    for s in split_sentences(text):
        ids = tokenizer.encode(s, add_special_tokens=False)[
            :max_sentence_tokens
        ]
        if ids:
            sents.append(ids)
    if not sents:
        return []
    return greedy_pack_spans(sents, target_len, break_prob, rng)


def preprocess_corpus_to_spans(
    corpus_jsonl: str,
    out_jsonl: str,
    tokenizer,
    target_len: int = 30,
    break_prob: float = 0.1,
    seed: int = 0,
    lowercase: bool = True,
    min_spans: int = 1,
) -> int:
    """BEIR corpus.jsonl -> span-corpus jsonl. Returns #docs written."""
    rng = random.Random(seed)
    n = 0
    with open(corpus_jsonl, encoding="utf8") as f, open(
        out_jsonl, "w", encoding="utf8"
    ) as out:
        for line in f:
            doc = json.loads(line)
            title = (doc.get("title") or "").strip()
            body = (doc.get("text") or "").strip()
            text = f"{title}. {body}" if title else body
            if lowercase:
                text = text.lower()
            spans = doc_to_spans(text, tokenizer, target_len, break_prob, rng)
            if len(spans) < min_spans:
                continue
            out.write(json.dumps({"spans": spans}) + "\n")
            n += 1
    return n


def span_batches(
    span_jsonl_paths: Iterable[str],
    collator,
    docs_per_batch: int,
    seed: int = 0,
    num_epochs: int = 1,
    start_batch: int = 0,
) -> Iterator[dict]:
    """Batched stream over one or more span corpora (the 18-task mix):
    shuffled doc order per epoch, 2 spans per doc via the co-collator.

    start_batch: resume fast-forward — the epoch shuffles are replayed (same
    seed => same order) but the first N batches are skipped BEFORE collation,
    so resuming costs doc-list indexing, not WWM-masking every skipped batch
    (the reference resumes via the HF Trainer's dataloader skip,
    COCO/run_coco_pre_training.py:146-152)."""
    docs = []
    for p in span_jsonl_paths:
        with open(p, encoding="utf8") as f:
            docs.extend(json.loads(l) for l in f)
    rng = random.Random(seed)
    batch_no = 0
    reseed = getattr(collator, "reseed", None)
    for _ in range(num_epochs):
        order = list(range(len(docs)))
        rng.shuffle(order)
        for s in range(0, len(order) - docs_per_batch + 1, docs_per_batch):
            batch_no += 1
            if batch_no <= start_batch:
                continue
            batch_docs = [docs[i] for i in order[s : s + docs_per_batch]]
            if reseed is not None:  # per-batch keyed masks => exact resume
                reseed(batch_no)
            yield collator.collate_spans(batch_docs)


def count_span_batches(
    span_jsonl_paths: Iterable[str], docs_per_batch: int, num_epochs: int = 1
) -> int:
    """Total optimizer steps of a COCO run (for warmup_ratio -> warmup
    steps, reference COCO/trainer.py:66-70): line counts are cheap relative
    to loading the spans."""
    n_docs = 0
    for p in span_jsonl_paths:
        with open(p, encoding="utf8") as f:
            n_docs += sum(1 for _ in f)
    return (n_docs // docs_per_batch) * num_epochs
