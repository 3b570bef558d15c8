"""Stage configurations: the counterpart of cocodr_tpu/core/configs.py for
the BM25 warmup (`OptimizerConfig`, `WarmupStageConfig`), with the
hyperparameters of record (reference warmup/README.md and
warmup/commands/run_bm25_warmup.sh).

`OptimizerConfig.build` makes the reference LAMB with the linear or cosine
schedule. What it does not build yet raises NotImplementedError with the
ROADMAP.md item that brings it: AdamW and gradient accumulation (Queue 1
item 13), the ANCE episode schedules (item 9).
"""
from __future__ import annotations

import dataclasses

from cocodr_tpu_torch.models.bert import BertConfig


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "lamb"  # 'lamb' | 'adamw'
    lr: float = 1e-4
    warmup_steps: int = 1000
    total_steps: int = 100_000
    schedule: str = "linear"  # 'linear'|'cosine'|'episode-rewarmup'|'episode-decay'
    episode_steps: int = 0  # steps per ANCE episode (episode-rewarmup)
    lr_floor: float = 0.2
    weight_decay: float = 0.0
    eps: float = 1e-6
    max_grad_norm: float = 1.0
    grad_accum_steps: int = 1

    def build(self, params):
        """-> a torch.optim.Optimizer over params."""
        from cocodr_tpu_torch.optim import Lamb, warmup_cosine, warmup_linear

        if self.schedule in ("episode-rewarmup", "episode-decay"):
            raise NotImplementedError(
                f"schedule {self.schedule!r} comes with ANCE: ROADMAP.md "
                "Queue 1 item 9 (optim/schedules.py has the function)"
            )
        if self.schedule not in ("linear", "cosine"):
            raise ValueError(self.schedule)
        if self.name == "adamw":
            raise NotImplementedError(
                "adamw is not ported yet: ROADMAP.md Queue 1 item 13"
            )
        if self.name != "lamb":
            raise ValueError(self.name)
        if self.grad_accum_steps > 1:
            raise NotImplementedError(
                "grad_accum_steps > 1 is not ported yet: ROADMAP.md Queue 1 "
                "item 13"
            )
        sched = (warmup_linear if self.schedule == "linear"
                 else warmup_cosine)(self.lr, self.warmup_steps,
                                     self.total_steps)
        return Lamb(params, sched, eps=self.eps,
                    weight_decay=self.weight_decay)


@dataclasses.dataclass(frozen=True)
class WarmupStageConfig:
    """BM25 warmup (reference warmup/README.md + run_bm25_warmup.sh)."""

    bert: BertConfig = BertConfig()
    model_type: str = "rdot_nll_condenser"
    optimizer: OptimizerConfig = OptimizerConfig(
        name="lamb", lr=2e-4, warmup_steps=1000, total_steps=410_000
    )
    per_device_batch: int = 256
    num_epochs: int = 3
    max_seq_len: int = 128
    save_steps: int = 10_000

    @classmethod
    def base(cls):
        return cls()

    @classmethod
    def large(cls):
        return cls(
            bert=BertConfig.large(),
            optimizer=OptimizerConfig(
                name="lamb", lr=5e-5, warmup_steps=5000, total_steps=1_640_000
            ),
            per_device_batch=64,
        )
