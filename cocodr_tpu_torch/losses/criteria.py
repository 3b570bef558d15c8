"""Auxiliary criteria and their registry: the counterpart of
cocodr_tpu/losses/criteria.py (reference ANCE/model/loss.py:8-299; the
warmup driver imports SymKlCriterion, the rest ship as a selectable
registry). Functions of logits, computed in float32; `alpha` scales each
criterion as the reference's constructor argument does. Reductions follow
the reference: batchmean for the KL family, mean for CE and MSE. Where the
reference detaches a side, so does the port (`.detach()` for the JAX
package's stop_gradient).
"""
from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F


def _lsm(x):
    return F.log_softmax(x.float(), dim=-1)


def _sm(x):
    return F.softmax(x.float(), dim=-1)


def ce_loss(logits, target_ids, alpha: float = 1.0, ignore_index: int = -1):
    """Cross entropy against integer targets; ignore_index rows count in
    neither the sum nor the mean."""
    lsm = _lsm(logits)
    valid = target_ids != ignore_index
    safe = torch.where(valid, target_ids, torch.zeros_like(target_ids))
    nll = -torch.gather(lsm, -1, safe.long()[..., None])[..., 0]
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    return alpha * nll.sum() / valid.sum().clamp_min(1)


def mse_loss(input_logits, target_logits, alpha: float = 1.0):
    return alpha * torch.mean(torch.square(input_logits.float()
                                           - target_logits.float()))


def kl_loss(input_logits, target_logits, alpha: float = 1.0):
    """KL(target || input), batchmean."""
    p = _sm(target_logits)
    kl = torch.sum(p * (_lsm(target_logits) - _lsm(input_logits)), dim=-1)
    return alpha * torch.mean(kl)


def stable_kl_loss(input_logits, target_logits, alpha: float = 1.0,
                   epsilon: float = 1e-6):
    """The reference's stabilised KL (loss.py `stable_kl`): the log-ratio
    terms detached (loss.py:13-14), the gradient through the leading p."""
    p = _sm(input_logits)
    y = _sm(target_logits)
    rp = -torch.log(1.0 / (p + epsilon) - 1.0 + epsilon).detach()
    ry = -torch.log(1.0 / (y + epsilon) - 1.0 + epsilon).detach()
    return alpha * torch.mean(torch.sum(p * (rp - ry) * 2.0, dim=-1))


def sym_kl_loss(input_logits, target_logits, alpha: float = 1.0):
    """Symmetric KL (SymKlCriterion, loss.py:112-127): each direction
    holds the other distribution constant, the terms summed without a 0.5
    factor, batchmean: KL(sg(p_t) || p_i) + KL(sg(p_i) || p_t)."""
    p_t = _sm(target_logits).detach()
    p_i = _sm(input_logits).detach()
    lp_t = torch.log(p_t.clamp_min(1e-30))
    lp_i = torch.log(p_i.clamp_min(1e-30))
    term1 = torch.sum(p_t * (lp_t - _lsm(input_logits)), dim=-1)
    term2 = torch.sum(p_i * (lp_i - _lsm(target_logits)), dim=-1)
    return alpha * torch.mean(term1 + term2)


def js_loss(input_logits, target_logits, alpha: float = 1.0):
    """JSCriterion (loss.py:145-163): m the detached mean distribution,
    KL(m || p_x) for each side summed without a 0.5 factor, batchmean."""
    m = (0.5 * (_sm(input_logits) + _sm(target_logits))).detach()
    lm = torch.log(m.clamp_min(1e-30))
    kl_m_i = torch.sum(m * (lm - _lsm(input_logits)), dim=-1)
    kl_m_t = torch.sum(m * (lm - _lsm(target_logits)), dim=-1)
    return alpha * torch.mean(kl_m_i + kl_m_t)


def hellinger_loss(input_logits, target_logits, alpha: float = 1.0):
    """HLCriterion (loss.py:165-177): the element mean of the squared
    difference of the square-rooted distributions, both detached, so that
    it passes no gradient (the reference's quirk, kept)."""
    p = torch.sqrt(_sm(input_logits)).detach()
    q = torch.sqrt(_sm(target_logits)).detach()
    return alpha * torch.mean(torch.square(p - q))


def rank_ce_loss(pos_scores, neg_scores, alpha: float = 1.0):
    """Pairwise ranking as a 2-way CE (RankCeCriterion)."""
    logits = torch.stack([pos_scores, neg_scores], dim=-1).float()
    return alpha * torch.mean(-F.log_softmax(logits, dim=-1)[..., 0])


def span_ce_loss(start_logits, end_logits, start_ids, end_ids,
                 alpha: float = 1.0):
    """Span extraction CE over start and end (SpanCeCriterion)."""
    return alpha * 0.5 * (ce_loss(start_logits, start_ids)
                          + ce_loss(end_logits, end_ids))


def mlm_criterion(logits, labels, alpha: float = 1.0):
    return ce_loss(logits, labels, alpha=alpha, ignore_index=-100)


LOSS_REGISTRY: Dict[str, Callable] = {
    "ce": ce_loss,
    "mse": mse_loss,
    "kl": kl_loss,
    "stable_kl": stable_kl_loss,
    "sym_kl": sym_kl_loss,
    "js": js_loss,
    "hellinger": hellinger_loss,
    "rank_ce": rank_ce_loss,
    "span_ce": span_ce_loss,
    "mlm": mlm_criterion,
}
