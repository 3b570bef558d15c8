"""Stage configurations: the counterpart of cocodr_tpu/core/configs.py for
the BM25 warmup and ANCE (`OptimizerConfig`, `WarmupStageConfig`,
`AnceStageConfig`), with the hyperparameters of record (reference
warmup/README.md, warmup/commands/run_bm25_warmup.sh, ANCE/README.md).

`OptimizerConfig.build` makes the reference LAMB with the linear, cosine
or ANCE episode schedules. What it does not build yet raises
NotImplementedError with the ROADMAP.md item that brings it: AdamW and
gradient accumulation (Queue 1 item 13).
"""
from __future__ import annotations

import dataclasses

from cocodr_tpu_torch.losses.dro import DroConfig
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
        from cocodr_tpu_torch.optim.schedules import (
            episode_decay,
            episode_rewarmup,
        )

        if self.schedule not in ("linear", "cosine", "episode-rewarmup",
                                 "episode-decay"):
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
        if self.schedule == "episode-decay":
            sched = episode_decay(self.lr, self.warmup_steps,
                                  self.total_steps, floor=self.lr_floor,
                                  episode_steps=self.episode_steps)
        elif self.schedule == "episode-rewarmup":
            if self.episode_steps <= 0:
                raise ValueError("episode-rewarmup needs episode_steps > 0")
            sched = episode_rewarmup(self.lr, self.warmup_steps,
                                     self.episode_steps, self.total_steps,
                                     floor=self.lr_floor)
        else:
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


@dataclasses.dataclass(frozen=True)
class AnceStageConfig:
    """ANCE + iDRO finetuning (reference ANCE/README.md Key
    Hyperparameters)."""

    bert: BertConfig = BertConfig()
    model_type: str = "rdot_nll_condenser"
    optimizer: OptimizerConfig = OptimizerConfig(
        name="lamb", lr=5e-6, warmup_steps=3000, total_steps=45_000
    )
    per_device_batch: int = 64
    eval_batch: int = 512
    dro: DroConfig = DroConfig(
        n_groups=50, alpha=0.25, ema=0.1, rho=0.05, eps=0.01
    )
    loss_kind: str = "idro"  # 'nll' | 'dro-greedy' | 'idro'
    idro_last_k_layers: int = 3
    topk_training: int = 200
    negative_sample: int = 30
    max_steps_per_episode: int = 45_000
    max_query_len: int = 64
    max_doc_len: int = 128

    @classmethod
    def base(cls):
        return cls()

    @classmethod
    def large(cls):
        return cls(
            bert=BertConfig.large(),
            optimizer=OptimizerConfig(
                name="lamb", lr=5e-6, warmup_steps=3000, total_steps=30_000
            ),
            per_device_batch=32,
            max_steps_per_episode=30_000,
            idro_last_k_layers=2,  # dro_loss.py:179-183
        )
