"""Training data streams: the counterpart of cocodr_tpu/data/streams.py.

The BM25 warmup's raw-text triples (`parse_triples_tsv_line`), and ANCE's
ann-data triplets: the parser of the miner's 5-column lines (qid \t
pos_pid \t neg1,neg2,... [\t weight \t cluster_id], the format the
reference miner writes, ANCE/drivers/run_ann_data_gen.py:416-423), their
expansion into one triplet per negative, rank sharding by global line index
(i % world == rank, reference ANCE/utils/util.py:372-399) and batching
over token caches (reference ANCE/data/msmarco_data.py:359-384).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List, Sequence

import numpy as np

from cocodr_tpu_torch.data.records import TokenCache


def parse_triples_tsv_line(line: str):
    """`query \t positive \t negative` -> the three texts (reference
    ANCE/data/process_fn.py); a line of fewer fields raises ValueError."""
    q, pos, neg = line.rstrip("\n").split("\t")[:3]
    return q, pos, neg


@dataclasses.dataclass
class Triplet:
    qid: int
    pos_pid: int
    neg_pid: int
    weight: float = 1.0
    group: int = 0


def parse_ann_line(line: str) -> tuple:
    """-> (qid, pos_pid, [neg_pids], weight, cluster_id)."""
    parts = line.rstrip("\n").split("\t")
    qid, pos = int(parts[0]), int(parts[1])
    negs = [int(x) for x in parts[2].split(",") if x]
    weight = float(parts[3]) if len(parts) > 3 else 1.0
    group = int(float(parts[4])) if len(parts) > 4 else 0
    return qid, pos, negs, weight, group


def triplets_from_ann_lines(
    lines: Sequence[str],
    rank: int = 0,
    world_size: int = 1,
) -> Iterator[Triplet]:
    """Each ann line expands to one triplet per negative
    (reference msmarco_data.py:359-384)."""
    for i, line in enumerate(lines):
        if i % world_size != rank:
            continue
        qid, pos, negs, weight, group = parse_ann_line(line)
        for neg in negs:
            yield Triplet(qid, pos, neg, weight, group)


@dataclasses.dataclass
class TripletBatch:
    """Device-ready int32 arrays for one training step."""

    query_ids: np.ndarray  # [B, Lq]
    query_mask: np.ndarray
    pos_ids: np.ndarray  # [B, Ld]
    pos_mask: np.ndarray
    neg_ids: np.ndarray
    neg_mask: np.ndarray
    weights: np.ndarray  # [B]
    groups: np.ndarray  # [B]
    qids: np.ndarray  # [B]


class TripletBatcher:
    """Assembles TripletBatch from token caches + a triplet stream."""

    def __init__(self, query_cache: TokenCache, passage_cache: TokenCache):
        self.qc = query_cache
        self.pc = passage_cache

    def collate(self, triplets: List[Triplet]) -> TripletBatch:
        qid = np.array([t.qid for t in triplets], np.int64)
        pos = np.array([t.pos_pid for t in triplets], np.int64)
        neg = np.array([t.neg_pid for t in triplets], np.int64)
        q_ids, q_mask = self.qc.batch_with_mask(qid)
        p_ids, p_mask = self.pc.batch_with_mask(pos)
        n_ids, n_mask = self.pc.batch_with_mask(neg)
        return TripletBatch(
            query_ids=q_ids,
            query_mask=q_mask,
            pos_ids=p_ids,
            pos_mask=p_mask,
            neg_ids=n_ids,
            neg_mask=n_mask,
            weights=np.array([t.weight for t in triplets], np.float32),
            groups=np.array([t.group for t in triplets], np.int32),
            qids=qid,
        )

    def batches(
        self,
        triplets: Iterator[Triplet],
        batch_size: int,
        drop_last: bool = True,
    ) -> Iterator[TripletBatch]:
        buf: List[Triplet] = []
        for t in triplets:
            buf.append(t)
            if len(buf) == batch_size:
                yield self.collate(buf)
                buf = []
        if buf and not drop_last:
            yield self.collate(buf)


def shuffled_ann_lines(lines: List[str], seed: int) -> List[str]:
    rng = np.random.RandomState(seed)
    order = rng.permutation(len(lines))
    return [lines[i] for i in order]


def shard_indices(n: int, rank: int, world_size: int) -> np.ndarray:
    """Deterministic inference sharding i % world == rank
    (reference util.py:384-399)."""
    return np.arange(rank, n, world_size)
