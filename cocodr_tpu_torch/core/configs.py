"""Stage configurations: the counterpart of cocodr_tpu/core/configs.py for
COCO pretraining, the BM25 warmup and ANCE (`OptimizerConfig`,
`CocoStageConfig`, `WarmupStageConfig`, `AnceStageConfig`), with the
hyperparameters of record (reference COCO/README.md, warmup/README.md,
warmup/commands/run_bm25_warmup.sh, ANCE/README.md).

`to_json` and `PRESETS` (the six stage presets by name) are the JAX
module's, for the CLI's `presets` and `--preset`; a preset's JSON carries
the JAX one's keys and values, the compute dtype written as torch names
it.

`OptimizerConfig.build` makes the reference LAMB or optax.adamw's AdamW
with the linear, cosine or ANCE episode schedules, wrapped in
optim/multi_steps.py's MultiSteps (optax.MultiSteps) when grad_accum_steps
is above 1.
"""
from __future__ import annotations

import dataclasses
import json

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
    # gradient accumulation (DDP no_sync's counterpart; reference
    # warmup/drivers/run_bm25_warmup.py:211-215). It does not give a larger
    # CONTRASTIVE batch (the COCO/README warning): each micro-batch's
    # in-batch negatives are its own; the grad cache or more devices give
    # that.
    grad_accum_steps: int = 1

    def build(self, params):
        """-> a torch.optim.Optimizer over params, or a MultiSteps around
        one when grad_accum_steps > 1."""
        from cocodr_tpu_torch.optim import (
            AdamW,
            Lamb,
            MultiSteps,
            warmup_cosine,
            warmup_linear,
        )
        from cocodr_tpu_torch.optim.schedules import (
            episode_decay,
            episode_rewarmup,
        )

        if self.schedule not in ("linear", "cosine", "episode-rewarmup",
                                 "episode-decay"):
            raise ValueError(self.schedule)
        if self.name not in ("lamb", "adamw"):
            raise ValueError(self.name)
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
        opt = (Lamb if self.name == "lamb" else AdamW)(
            params, sched, eps=self.eps, weight_decay=self.weight_decay)
        if self.grad_accum_steps > 1:
            return MultiSteps(opt, self.grad_accum_steps)
        return opt


@dataclasses.dataclass(frozen=True)
class CocoStageConfig:
    """COCO pretraining (reference COCO/README.md Key Hyperparameter; the
    fields of COCO/arguments.py:20-134: mlm_probability :66-68,
    n_head_layers/skip_from/late_mlm :120-122, warmup_ratio :127,
    cache_chunk_size :134)."""

    bert: BertConfig = BertConfig()
    optimizer: OptimizerConfig = OptimizerConfig(lr=1e-4, schedule="linear")
    per_device_batch_docs: int = 200  # x2 spans
    num_epochs: int = 8
    warmup_ratio: float = 0.1
    max_seq_length: int = 128
    mlm_probability: float = 0.15
    n_head_layers: int = 2
    skip_from: int = 6
    late_mlm: bool = True
    cache_chunk_size: int = 0
    # the MLM decoder's gather budget as a fraction of B * S; the WWM
    # collator masks at most round(mlm_probability * len) tokens a
    # sequence, so any frac >= mlm_probability + 1 / (2 * max_seq_length)
    # covers every masked position
    mlm_budget_frac: float = 0.17

    def warmup_steps_for(self, total_steps: int) -> int:
        """warmup_ratio -> warmup steps from the run's step budget
        (reference COCO/trainer.py:66-70: num_training_steps *
        warmup_ratio, overriding a fixed warmup_steps)."""
        if self.warmup_ratio > 0 and total_steps > 0:
            return max(1, int(total_steps * self.warmup_ratio))
        return self.optimizer.warmup_steps

    @classmethod
    def base(cls):
        return cls()

    @classmethod
    def large(cls):
        return cls(
            bert=BertConfig.large(),
            optimizer=OptimizerConfig(lr=1e-5, schedule="linear"),
            per_device_batch_docs=100,
            skip_from=12,
        )


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


def to_json(cfg) -> str:
    """A stage config -> indented JSON, nested configs as objects and
    anything else JSON lacks (the compute dtype) as its str()."""
    return json.dumps(dataclasses.asdict(cfg), default=str, indent=2)


PRESETS = {
    "coco-base": CocoStageConfig.base,
    "coco-large": CocoStageConfig.large,
    "warmup-base": WarmupStageConfig.base,
    "warmup-large": WarmupStageConfig.large,
    "ance-base": AnceStageConfig.base,
    "ance-large": AnceStageConfig.large,
}
