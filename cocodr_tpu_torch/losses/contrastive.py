"""coCondenser's span contrastive loss: the counterpart of
cocodr_tpu/losses/contrastive.py (reference COCO/modeling.py:172-190).

Each document contributes two consecutive spans, so the targets pair rows
2i and 2i + 1 with each other (`flipped_pair_targets`); every span of the
batch is a candidate, the span itself excepted (its column is set to
-inf). The similarity is a float32 [B, B] product of the CLS embeddings.

The explicit-collective form of the JAX package (`axis_name=`, the
all-gathered candidates of a shard_map) waits for the multi-device port:
ROADMAP.md Queue 1 item 11.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def flipped_pair_targets(n: int, device=None) -> torch.Tensor:
    """[1, 0, 3, 2, 5, 4, ...] of length n (n even), int64."""
    t = torch.arange(n, device=device).view(-1, 2)
    return t.flip(1).reshape(-1)


def co_contrastive_loss(cls_emb: torch.Tensor, axis_name: Optional[str] = None,
                        reduction: str = "mean") -> torch.Tensor:
    """Contrastive loss over span CLS embeddings [B, D] (two consecutive
    spans a document): the mean over rows of the cross-entropy of each
    row's float32 similarities, its own column masked to -inf, against
    its pair's column; reduction="none" gives the [B] per-row losses."""
    if axis_name is not None:
        raise NotImplementedError(
            "co_contrastive_loss(axis_name=...) (candidates gathered over "
            "devices) is not ported yet: ROADMAP.md Queue 1 item 11 "
            "(multi-device)"
        )
    f32 = cls_emb.float()
    n = f32.shape[0]
    sim = f32 @ f32.T
    eye = torch.eye(n, dtype=torch.bool, device=f32.device)
    sim = sim.masked_fill(eye, float("-inf"))
    loss = F.cross_entropy(sim, flipped_pair_targets(n, f32.device),
                           reduction="none")
    if reduction == "none":
        return loss
    return loss.mean()
