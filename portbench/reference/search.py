"""A plain exact top-k search: float32 scores of every corpus row, in blocks
of rows, with TF32 off; and the int8 control, the same search over rows and
queries quantized to int8 with one scale a row."""
from __future__ import annotations

import torch

from portbench.reference.bert import float32_products


def _int8_rows(x: torch.Tensor):
    """Symmetric int8 with one scale a row -> (int8 values as float32,
    scales [R, 1])."""
    x = x.float()
    scale = x.abs().amax(1, keepdim=True).clamp_min(1e-30) / 127.0
    return torch.round(x / scale).clamp(-127, 127), scale


@torch.no_grad()
def exact_topk(queries, corpus, n: int, k: int, block: int = 1 << 20,
               int8: bool = False):
    """The top k of queries [R, D] over corpus rows [:n] -> (scores [R, k]
    float32 descending, ids [R, k] int64). int8: the control, every row
    and query rounded to int8 (the products of int8 values are exact in
    float32 at D <= 1,040), the scores dequantized."""
    with float32_products():
        if int8:
            q, qs = _int8_rows(queries)
        else:
            q, qs = queries.float(), None
        best_v = best_i = None
        for s in range(0, n, block):
            if int8:
                c, cs = _int8_rows(corpus[s:min(s + block, n)])
                sc = (q @ c.T) * qs * cs.T
            else:
                sc = q @ corpus[s:min(s + block, n)].float().T
            v, i = torch.topk(sc, min(k, sc.shape[1]), dim=1)
            i = i + s
            if best_v is not None:
                v, pos = torch.topk(torch.cat([best_v, v], 1), k, dim=1)
                i = torch.cat([best_i, i], 1).gather(1, pos)
            best_v, best_i = v, i
    return best_v, best_i


@torch.no_grad()
def scores_of(queries, corpus, ids):
    """Exact float32 scores of queries [R, D] with the rows ids [R, k]
    (clamped into the corpus; the comparison judges ids out of range)."""
    with float32_products():
        idx = ids.long().clamp(0, corpus.shape[0] - 1)
        rows = corpus[idx].float()  # [R, k, D]
        return torch.bmm(rows, queries.float()[:, :, None])[:, :, 0]
