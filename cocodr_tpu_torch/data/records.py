"""Fixed-width binary token-record files and memmap random access: the
port's own copy of cocodr_tpu/data/records.py (`RecordWriter`,
`TokenCache`, `save_id_map`, `load_id_map`, `write_qrels`, `load_qrels`).

The file format is the JAX package's, byte for byte (and the reference's):

    record  = length (4 bytes big-endian) + int32[max_len] token ids
              (native little-endian)
    _meta   = JSON {"type": "int32", "total_number": N, "embedding_size": L}
    id maps = {external_id -> offset} pickle (pid2offset / qid2offset)
    qrels   = qid_offset \t pid_offset \t rel lines (offset space)

The whole file is a numpy memmap and batch gathers are vectorized fancy
indexing. data/native.py's NativeTokenCache reads the same files with
threaded gathers in C++ and gives the same arrays; the CLI and
pipelines/eval_beir.py read through it, as the JAX package's do.
"""
from __future__ import annotations

import json
import pickle
from typing import Iterable, Sequence, Tuple

import numpy as np


class RecordWriter:
    """Streaming writer for the length + tokens record format."""

    def __init__(self, path: str, max_len: int):
        self.path = path
        self.max_len = max_len
        self.count = 0
        self._f = open(path, "wb")

    def write(self, token_ids: Sequence[int]) -> int:
        """Returns the record's offset index."""
        n = min(len(token_ids), self.max_len)
        arr = np.zeros(self.max_len, np.int32)
        arr[:n] = np.asarray(token_ids[: self.max_len], np.int32)
        self._f.write(int(n).to_bytes(4, "big"))
        self._f.write(arr.tobytes())
        idx = self.count
        self.count += 1
        return idx

    def close(self):
        self._f.close()
        meta = {
            "type": "int32",
            "total_number": self.count,
            "embedding_size": self.max_len,
        }
        with open(self.path + "_meta", "w") as f:
            json.dump(meta, f)

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class TokenCache:
    """Random-access reader over a memmap of a record file."""

    def __init__(self, path: str):
        self.path = path
        with open(path + "_meta") as f:
            meta = json.load(f)
        self.dtype = np.dtype(meta["type"])
        self.total_number = int(meta["total_number"])
        self.max_len = int(meta["embedding_size"])
        self.record_bytes = 4 + self.max_len * self.dtype.itemsize
        raw = np.memmap(path, dtype=np.uint8, mode="r")
        if raw.size != self.total_number * self.record_bytes:
            raise ValueError(
                f"{path}: size {raw.size} != {self.total_number} x "
                f"{self.record_bytes}"
            )
        self._rows = raw.reshape(self.total_number, self.record_bytes)

    def __len__(self):
        return self.total_number

    def __getitem__(self, idx: int) -> Tuple[int, np.ndarray]:
        row = self._rows[idx]
        length = int.from_bytes(bytes(row[:4]), "big")
        return length, row[4:].view(self.dtype)

    def batch(self, indices) -> Tuple[np.ndarray, np.ndarray]:
        """Vectorized gather: (lengths [B] int32, tokens [B, max_len])."""
        rows = self._rows[np.asarray(indices)]
        lengths = rows[:, :4].copy().view(">i4")[:, 0].astype(np.int32)
        tokens = rows[:, 4:].copy().view(self.dtype)
        return lengths, tokens

    def batch_with_mask(self, indices):
        """(tokens [B, L], attention_mask [B, L] int32) for the encoder."""
        lengths, tokens = self.batch(indices)
        mask = (
            np.arange(self.max_len)[None, :] < lengths[:, None]
        ).astype(np.int32)
        return tokens, mask

    def lengths(self) -> np.ndarray:
        """All record lengths [N] (one strided pass over the 4-byte
        prefixes)."""
        return self._rows[:, :4].copy().view(">i4")[:, 0].astype(np.int32)


def save_id_map(mapping: dict, path: str):
    with open(path, "wb") as f:
        pickle.dump(mapping, f, protocol=4)


def load_id_map(path: str) -> dict:
    with open(path, "rb") as f:
        return pickle.load(f)


def write_qrels(path: str, rows: Iterable[Tuple[int, int, int]]):
    """Offset-space qrels: qid_offset \t pid_offset \t rel
    (reference msmarco_data.py:109-128)."""
    with open(path, "w") as f:
        for q, p, rel in rows:
            f.write(f"{q}\t{p}\t{rel}\n")


def load_qrels(path: str, graded: bool = True) -> dict:
    """qid -> {pid: rel} (rel 1 for every pair unless graded)."""
    out: dict = {}
    with open(path) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            q, p, rel = int(parts[0]), int(parts[1]), int(parts[2])
            out.setdefault(q, {})[p] = rel if graded else 1
    return out
