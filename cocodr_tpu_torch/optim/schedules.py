"""Learning-rate schedules with HF-transformers semantics: the counterpart
of cocodr_tpu/optim/schedules.py, as plain functions of the step.

Each computes in float32, as the JAX functions do under jnp, and returns a
Python float. `warmup_linear` keeps the JAX function's reading of step 0:
its rate is 0 even with warmup_steps=0 (HF's schedule would give the base
rate), and optax reads the schedule at the update count before it
increments, so the first update of a run has learning rate 0.
"""
from __future__ import annotations

import numpy as np

_f = np.float32


def _clip01(x):
    return min(max(x, _f(0.0)), _f(1.0))


def warmup_linear(base_lr: float, warmup_steps: int, total_steps: int):
    def fn(step) -> float:
        step = _f(step)
        warm = step / _f(max(1.0, warmup_steps))
        decay = (_f(total_steps) - step) / _f(max(1.0,
                                                  total_steps - warmup_steps))
        return float(_f(base_lr) * _clip01(min(warm, decay)))

    return fn


def warmup_cosine(base_lr: float, warmup_steps: int, total_steps: int,
                  num_cycles: float = 0.5):
    def fn(step) -> float:
        step = _f(step)
        warm = _clip01(step / _f(max(1.0, warmup_steps)))
        progress = _clip01((step - _f(warmup_steps))
                           / _f(max(1.0, total_steps - warmup_steps)))
        cos = _f(0.5) * (_f(1.0) + np.cos(_f(np.pi * 2.0 * num_cycles)
                                          * progress))
        out = warm if step < warmup_steps else max(_f(0.0), cos)
        return float(_f(base_lr) * out)

    return fn


def episode_rewarmup(base_lr: float, warmup_steps: int,
                     steps_per_episode: int, total_steps: int,
                     floor: float = 0.2):
    """ANCE re-warmup: each mining episode restarts the warmup while the
    base rate decays with overall progress to `floor`."""
    def fn(step) -> float:
        step = _f(step)
        in_ep = np.mod(step, _f(steps_per_episode))
        warm = _clip01(in_ep / _f(max(1.0, warmup_steps)))
        decay = max(_f(floor), _f(1.0) - step / _f(total_steps))
        return float(_f(base_lr) * warm * decay)

    return fn


def episode_decay(base_lr: float, warmup_steps: int, total_steps: int,
                  floor: float = 0.2, episode_steps: int = 0):
    """ANCE episode decay without re-warmup: one warmup, then
    max(floor, 1 - step / total); episode_steps > 0 holds the factor at
    each episode's first step."""
    def fn(step) -> float:
        step = _f(step)
        warm = _clip01(step / _f(max(1.0, warmup_steps)))
        eff = (np.floor(step / _f(episode_steps)) * _f(episode_steps)
               if episode_steps > 0 else step)
        decay = max(_f(floor), _f(1.0) - eff / _f(total_steps))
        return float(_f(base_lr) * warm * decay)

    return fn


def warmup_constant(base_lr: float, warmup_steps: int):
    def fn(step) -> float:
        return float(_f(base_lr)
                     * _clip01(_f(step) / _f(max(1.0, warmup_steps))))

    return fn
