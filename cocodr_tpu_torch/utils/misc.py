"""Small utilities: the port's copy of cocodr_tpu/utils/misc.py."""
from __future__ import annotations

import glob
import json
import os

import torch

# the reference's empirical embedding std (evaluate/model/models.py:81-89)
NOISE_SCALE = 26.8

# The reference's hardcoded BEIR task grouping used for per-task curves
# (reference ANCE/utils/util.py:237-260 `get_latest_group_result`).
BEIR_GROUP_NAMES = (
    "trec-covid",
    "nfcorpus",
    "fiqa",
    "arguana",
    "webis-touche2020",
    "dbpedia-entity",
    "scidocs",
    "climate-fever",
    "scifact",
)


def mean_teacher_update(teacher, student, average: str = "exponential",
                        alpha: float = 0.995, step: int | None = None):
    """EMA or simple-average teacher update (`mt_update`, reference
    ANCE/model/models.py:27-38). teacher, student: two state dicts (name
    -> tensor) or two lists of tensors of the same structure. Returns new
    tensors in that structure, without gradients, and changes neither
    argument (copy them into a model with `load_state_dict`)."""
    if average == "exponential":
        rate = 1.0 - alpha
    elif average == "simple":
        if step is None:
            raise ValueError("simple average requires step")
        rate = 1.0 / float(step)
    else:
        raise ValueError(average)
    with torch.no_grad():
        if isinstance(teacher, dict):
            return {k: t + rate * (student[k] - t)
                    for k, t in teacher.items()}
        return [t + rate * (s - t) for t, s in zip(teacher, student)]


def add_embedding_noise(emb, generator: torch.Generator, noise_level: float,
                        scale: float = NOISE_SCALE):
    """Gaussian embedding perturbation for robustness probing: emb +
    N(0, 1) * scale * noise_level, the noise drawn in float32 from
    `generator` (on emb's device) and cast to emb's dtype. The JAX package
    draws from a threefry key; the two give other numbers from the same
    seed, so only the distributions agree."""
    if noise_level <= 0:
        return emb
    noise = torch.randn(emb.shape, generator=generator, dtype=torch.float32,
                        device=emb.device)
    return emb + (noise * scale * noise_level).to(emb.dtype)


class AverageMeter:
    """Running average (reference ANCE/model/dro_loss.py:138-158)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0
        self.avg = 0.0

    def update(self, val, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count if self.count > 0 else 0.0


def read_group_results(result_dir: str, group_names=BEIR_GROUP_NAMES):
    """The newest per-BEIR-task nDCG file of each group: scans
    `ann_ndcg_group_{name}_{n}` JSONs (reference `get_latest_group_result`,
    ANCE/utils/util.py:237-260, with its 9 named groups) -> {name:
    {'ndcg': ..., 'checkpoint': ...}} for the groups found."""
    out = {}
    for name in group_names:
        best_n, best = -1, None
        for p in glob.glob(os.path.join(result_dir,
                                        f"ann_ndcg_group_{name}_*")):
            try:
                n = int(p.rsplit("_", 1)[1])
            except ValueError:
                continue
            if n > best_n:
                best_n, best = n, p
        if best:
            with open(best) as f:
                out[name] = json.load(f)
    return out


def episode_lr_decay(base_lr: float, step: int, total_steps: int,
                     floor: float = 0.2) -> float:
    """LR decay across ANCE episodes: lr <- max(floor, 1 - step/total) * lr
    (reference ANCE/drivers/run_ann.py:120-125)."""
    return max(floor, 1.0 - step / float(total_steps)) * base_lr


def lamb_trust_ratios(optimizer, model) -> dict:
    """Per-tensor LAMB trust ratios for diagnostics (the reference logs
    histograms of them, ANCE/utils/lamb.py:11-22), from the optimizer's
    current moments: clip(|p|, 0, 10) / |m / (sqrt(v) + 1e-6)|, 1 where
    either norm is 0, by parameter name. optimizer: an optim.lamb.Lamb or
    a MultiSteps around one; {} for another optimizer or before the first
    update. A parameter split over a model axis (parallel/tp.py) takes the
    norms of its whole tensor: every model rank calls this together."""
    from cocodr_tpu_torch.optim.lamb import Lamb
    from cocodr_tpu_torch.parallel.tp import model_sum_sq

    inner = getattr(optimizer, "inner", optimizer)
    if not isinstance(inner, Lamb):
        return {}
    names, params, sq = [], [], []
    with torch.no_grad():
        for name, p in model.named_parameters():
            st = inner.state.get(p)
            if not st:
                continue
            adam = st["exp_avg"] / (st["exp_avg_sq"].sqrt() + 1e-6)
            names.append(name)
            params.append(p)
            sq.append(torch.stack([p.float().square().sum(),
                                   adam.float().square().sum()]))
        if not names:
            return {}
        norms = torch.stack(sq)  # [n, 2]
        n = len(params)
        norms = model_sum_sq(params + params,
                             norms.t().reshape(-1)).view(2, n).sqrt()
    out = {}
    for name, wn, an in zip(names, norms[0].tolist(), norms[1].tolist()):
        wn = min(max(wn, 0.0), 10.0)
        out[name] = 1.0 if wn == 0 or an == 0 else wn / an
    return out
