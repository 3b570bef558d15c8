"""Training data streams: the counterpart of cocodr_tpu/data/streams.py.

This slice carries the BM25 warmup's raw-text triples. The ann-data
triplets of ANCE (`parse_ann_line`, `TripletBatcher`) come with ROADMAP.md
Queue 1 item 9.
"""
from __future__ import annotations


def parse_triples_tsv_line(line: str):
    """`query \\t positive \\t negative` -> the three texts (reference
    ANCE/data/process_fn.py); a line of fewer fields raises ValueError."""
    q, pos, neg = line.rstrip("\n").split("\t")[:3]
    return q, pos, neg
