"""coCondenser's span contrastive loss: the counterpart of
cocodr_tpu/losses/contrastive.py (reference COCO/modeling.py:172-190).

Each document contributes two consecutive spans, so the targets pair rows
2i and 2i + 1 with each other (`flipped_pair_targets`); every span of the
batch is a candidate, the span itself excepted (its column is set to
-inf). The similarity is a float32 [B, B] product of the CLS embeddings.

With `axis_name` (a process group, or a DeviceMesh's data axis) each
rank scores its own rows against the candidates all-gathered from every
rank (the JAX package's shard_map form, reference COCO/modeling.py:182-190,
244-248), through a differentiable all-gather.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
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
    its pair's column; reduction="none" gives the [B] per-row losses.

    With axis_name, cls_emb is this rank's [B_local, D] rows (B_local
    even: pairs never straddle ranks); its candidates are every rank's
    rows, all-gathered with gradients (`_GatherRows`), and its
    targets and masked column are offset by rank * B_local. The value is
    the mean over ranks of the ranks' means (JAX's pmean); the gradient is
    that of this rank's own mean, whose all-gather backward sums every
    rank's term into each rank's rows: W times the global mean's
    gradient, which a data-parallel step's mean all-reduce of the
    parameter gradients divides by W again (DDP's convention,
    parallel/sharded_train.py)."""
    if axis_name is not None:
        return _gathered_loss(cls_emb.float(), axis_name, reduction)
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


class _GatherRows(torch.autograd.Function):
    """The group's rows [W * B, D] in rank order; the backward sums the
    whole gradient over the group (one all-reduce) and keeps this rank's
    rows. (torch.distributed.nn's all_gather backward takes, over gloo,
    group ranks for global ones, and fails on a group that is not the
    whole world, as a data axis beside a model axis is.)"""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        B = grad.shape[0] // dist.get_world_size(ctx.group)
        r = dist.get_rank(ctx.group)
        return grad[r * B:(r + 1) * B], None


def _gathered_loss(f32, axis, reduction):
    from cocodr_tpu_torch.core.mesh import axis_group

    group = axis_group(axis)
    W = dist.get_world_size(group)
    B = f32.shape[0]
    off = dist.get_rank(group) * B
    cands = _GatherRows.apply(f32, group)
    sim = f32 @ cands.T
    rows = torch.arange(B, device=f32.device)
    own = torch.zeros(sim.shape, dtype=torch.bool, device=f32.device)
    own[rows, off + rows] = True
    sim = sim.masked_fill(own, float("-inf"))
    loss = F.cross_entropy(sim, off + flipped_pair_targets(B, f32.device),
                           reduction="none")
    if reduction == "none":
        return loss
    local = loss.mean()
    mean = local.detach().clone()
    dist.all_reduce(mean, group=group)
    return local + (mean / W - local.detach())
