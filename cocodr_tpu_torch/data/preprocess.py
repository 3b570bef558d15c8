"""Offline tokenization to binary record files: the port's own copy of
cocodr_tpu/data/preprocess.py.

- MS MARCO passages, queries and qrels (reference
  ANCE/data/msmarco_data.py:21-295): `tokenize_msmarco_passages`,
  `tokenize_queries`, `rewrite_qrels`;
- BEIR corpus.jsonl / queries.jsonl / qrels tsv with string-id maps
  (reference evaluate/data/beir_data.py:38-334).

Behavioural parity points, as in the JAX package:
- doc data_type=0 joins url/title/body with '<sep>'; every passage keeps
  its first MAX_DOC_CHARACTER (10000) characters (msmarco_data.py:250-259);
- condenser-family models lowercase MS MARCO text before tokenizing
  (msmarco_data.py:265-266,283-285: the `lowercase` flag);
- qrels are rewritten into offset space (msmarco_data.py:106-128);
- BEIR concatenates title + ' ' + text, lowercases, and maps string doc
  ids through p/qchar2pid pickles (beir_data.py:85-117,278-296);
- robust04 text is cleaned of other characters before lowercasing, docs
  and queries by their own patterns (beir_data.py:282-284, 322-324).

The tokenizer is any object with HuggingFace's `encode(text,
add_special_tokens=, max_length=, truncation=)`; the port does not import
`transformers`. Records carry [CLS]...[SEP] ids padded to max_len, in the
JAX package's format byte for byte (data/records.py).
"""
from __future__ import annotations

import csv
import gzip
import json
import os
import re
from typing import Dict, Optional

from cocodr_tpu_torch.data.records import (
    RecordWriter,
    save_id_map,
    write_qrels,
)

MAX_DOC_CHARACTER = 10000


def _encode(tokenizer, text: str, max_len: int):
    return tokenizer.encode(
        text, add_special_tokens=True, max_length=max_len, truncation=True
    )


# ---------------------------------------------------------------------------
# Parallel tokenization (reference `multi_file_process`,
# ANCE/utils/util.py:420-436 — 32-way process split). Records are fixed
# width, so each worker writes a contiguous part file and the parent
# concatenates them in order: the output is byte-identical to n_workers=1.
# Text extraction/cleanup stays in the parent (it is I/O-cheap); only the
# tokenizer hot loop fans out. Workers inherit the tokenizer by fork.

_WORKER_STATE: dict = {}


def _part_worker(job):
    part_idx, part_path, texts = job
    tokenizer = _WORKER_STATE["tokenizer"]
    max_len = _WORKER_STATE["max_len"]
    with RecordWriter(part_path, max_len) as w:
        for t in texts:
            w.write(_encode(tokenizer, t, max_len))
    return part_idx, len(texts)


def _write_records_streaming(pairs, tokenizer, out_path: str,
                             max_len: int) -> list:
    """Serial path: one pass, one line in memory at a time."""
    ids = []
    with RecordWriter(out_path, max_len) as w:
        for ext_id, text in pairs:
            ids.append(ext_id)
            w.write(_encode(tokenizer, text, max_len))
    return ids


def _write_records_parallel(pairs, tokenizer, out_path: str, max_len: int,
                            n_workers: int) -> list:
    """Fan the tokenizer loop over fork workers; byte-identical output.

    Buffers the (id, text) pairs in the parent — the price of the split
    (the reference pays it as on-disk line shards instead,
    util.py:420-427). Workers inherit the tokenizer by FORK: call before
    spawning device/tokenizer worker threads or touching the card; a
    thread-heavy parent should use n_workers=1.
    """
    import multiprocessing as mp

    pairs = list(pairs)
    if len(pairs) < 2 * n_workers:
        return _write_records_streaming(pairs, tokenizer, out_path, max_len)
    ids = [i for i, _ in pairs]
    step = (len(pairs) + n_workers - 1) // n_workers
    jobs = [
        (i, f"{out_path}.part{i}",
         [t for _, t in pairs[i * step:(i + 1) * step]])
        for i in range(n_workers)
    ]
    counts = [len(texts) for _, _, texts in jobs]
    del pairs  # one corpus-sized text buffer, not two
    _WORKER_STATE["tokenizer"] = tokenizer
    _WORKER_STATE["max_len"] = max_len
    try:
        ctx = mp.get_context("fork")
        with ctx.Pool(n_workers) as pool:
            pool.map(_part_worker, jobs)
        jobs = [(i, p, None) for i, p, _ in jobs]  # texts now on disk
        total = 0
        with open(out_path, "wb") as out:
            for (i, part_path, _), n_part in zip(jobs, counts):
                with open(part_path, "rb") as pf:
                    while True:
                        block = pf.read(1 << 24)
                        if not block:
                            break
                        out.write(block)
                total += n_part
        meta = {
            "type": "int32",
            "total_number": total,
            "embedding_size": max_len,
        }
        with open(out_path + "_meta", "w") as f:
            json.dump(meta, f)
    finally:
        _WORKER_STATE.clear()
        for i, part_path, _ in jobs:  # orphan cleanup on failure too
            for p in (part_path, part_path + "_meta"):
                if os.path.exists(p):
                    os.remove(p)
    return ids


def _write_record_pairs(pairs, tokenizer, out_path: str, max_len: int,
                        n_workers: int = 1) -> list:
    """Tokenize an iterator of (external_id, final_text) pairs into
    `out_path`; returns the ids in record order (record i holds pair i, so
    callers build id->offset maps by enumeration)."""
    if n_workers <= 1:
        return _write_records_streaming(pairs, tokenizer, out_path, max_len)
    return _write_records_parallel(pairs, tokenizer, out_path, max_len,
                                   n_workers)


# ---------------------------------------------------------------------------
# MS MARCO


def _maybe_lower(text: str, lowercase: bool) -> str:
    return text.lower() if lowercase else text


def tokenize_msmarco_passages(
    collection_tsv: str,
    out_path: str,
    tokenizer,
    max_len: int,
    lowercase: bool = False,
    data_type: int = 1,
    n_workers: int = 1,
) -> Dict[int, int]:
    """collection.tsv (pid \t text), or msmarco-docs.tsv with data_type=0
    (D-prefixed docid \t url \t title \t body), -> records + pid2offset
    (also pickled beside the records)."""
    def pairs():
        with open(collection_tsv, encoding="utf8") as f:
            for line in f:
                arr = line.rstrip("\n").split("\t")
                if data_type == 0:
                    pid = int(arr[0][1:])  # strip leading 'D'
                    text = (arr[1].rstrip() + "<sep>" + arr[2].rstrip()
                            + "<sep>" + arr[3].rstrip())
                else:
                    pid = int(arr[0])
                    text = _maybe_lower(arr[1].rstrip(), lowercase)
                yield pid, text[:MAX_DOC_CHARACTER]

    pids = _write_record_pairs(pairs(), tokenizer, out_path, max_len,
                               n_workers)
    pid2offset = {pid: i for i, pid in enumerate(pids)}
    save_id_map(pid2offset, out_path + ".pid2offset.pickle")
    return pid2offset


def tokenize_queries(
    queries_tsv: str,
    out_path: str,
    tokenizer,
    max_len: int,
    lowercase: bool = False,
    n_workers: int = 1,
) -> Dict[int, int]:
    """queries.*.tsv (qid \t text) -> records + qid2offset (also pickled
    beside the records)."""
    def pairs():
        with open(queries_tsv, encoding="utf8") as f:
            for line in f:
                arr = line.rstrip("\n").split("\t")
                yield int(arr[0]), _maybe_lower(arr[1].rstrip(), lowercase)

    qids = _write_record_pairs(pairs(), tokenizer, out_path, max_len,
                               n_workers)
    qid2offset = {qid: i for i, qid in enumerate(qids)}
    save_id_map(qid2offset, out_path + ".qid2offset.pickle")
    return qid2offset


def rewrite_qrels(
    qrels_path: str,
    out_path: str,
    qid2offset: Dict[int, int],
    pid2offset: Dict[int, int],
    delimiter: str = "\t",
    docid_prefix: bool = False,
):
    """TREC qrels (qid, _, docid, rel; gzipped when the name ends in 'gz')
    -> offset-space tsv (data.records.write_qrels); -> its rows. Lines of
    another width are skipped; docid_prefix strips a leading 'D'."""
    opener = (
        gzip.open(qrels_path, "rt", encoding="utf8")
        if qrels_path.endswith("gz")
        else open(qrels_path, encoding="utf8")
    )
    rows = []
    with opener as f:
        for parts in csv.reader(f, delimiter=delimiter):
            if len(parts) != 4:
                continue
            topicid, _, docid, rel = parts
            docid = int(docid[1:]) if docid_prefix else int(docid)
            rows.append((qid2offset[int(topicid)], pid2offset[docid],
                         int(rel)))
    write_qrels(out_path, rows)
    return rows


# ---------------------------------------------------------------------------
# BEIR

# robust04 character cleanup (reference evaluate/data/beir_data.py:282-284
# for docs, :322-324 for queries — the query variant drops '='). Applied
# before lowercasing, then whitespace-collapsed, exactly like the reference.
_ROBUST04_DOC_KEEP = re.compile(r"[^A-Za-z0-9=(),!?'`]")
_ROBUST04_QUERY_KEEP = re.compile(r"[^A-Za-z0-9(),!?'`]")


def _robust04_clean(text: str, pattern: re.Pattern) -> str:
    return " ".join(pattern.sub(" ", text).split())


def _beir_doc_text(doc: dict, clean: bool = False) -> str:
    title = (doc.get("title") or "").rstrip()
    text = (doc.get("text") or "").rstrip()
    if title:
        # titled docs are never cleaned, even for robust04 (beir_data.py:279)
        return (title + " " + text).lower()
    if clean:
        return _robust04_clean(doc.get("text") or "", _ROBUST04_DOC_KEEP).lower()
    return text.lower()


def tokenize_beir_corpus(
    corpus_jsonl: str,
    out_path: str,
    tokenizer,
    max_len: int,
    clean: bool = False,
    n_workers: int = 1,
) -> Dict[str, int]:
    """BEIR corpus.jsonl -> records + string-id map (pchar2pid equivalent)."""
    def pairs():
        with open(corpus_jsonl, encoding="utf8") as f:
            for line in f:
                doc = json.loads(line)
                yield str(doc["_id"]), _beir_doc_text(doc, clean)

    docids = _write_record_pairs(pairs(), tokenizer, out_path, max_len,
                                 n_workers)
    docid2offset = {did: i for i, did in enumerate(docids)}
    save_id_map(docid2offset, out_path + ".docid2offset.pickle")
    return docid2offset


def tokenize_beir_queries(
    queries_jsonl: str,
    out_path: str,
    tokenizer,
    max_len: int,
    keep: Optional[set] = None,
    clean: bool = False,
    n_workers: int = 1,
) -> Dict[str, int]:
    def pairs():
        with open(queries_jsonl, encoding="utf8") as f:
            for line in f:
                q = json.loads(line)
                qid = str(q["_id"])
                if keep is not None and qid not in keep:
                    continue
                text = q["text"]
                if clean:
                    text = _robust04_clean(text, _ROBUST04_QUERY_KEEP)
                yield qid, text.rstrip().lower()

    qids = _write_record_pairs(pairs(), tokenizer, out_path, max_len,
                               n_workers)
    qid2offset = {qid: i for i, qid in enumerate(qids)}
    save_id_map(qid2offset, out_path + ".qid2offset.pickle")
    return qid2offset


def load_beir_qrels(qrels_tsv: str) -> Dict[str, Dict[str, int]]:
    """BEIR qrels/test.tsv (query-id \t corpus-id \t score, with header)."""
    out: Dict[str, Dict[str, int]] = {}
    with open(qrels_tsv, encoding="utf8") as f:
        reader = csv.reader(f, delimiter="\t")
        header = next(reader)
        assert header[0].lower().replace("_", "-") in ("query-id", "qid"), header
        for qid, did, score in reader:
            out.setdefault(str(qid), {})[str(did)] = int(score)
    return out
