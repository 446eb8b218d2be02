"""Learning-rate schedules and the parameter-count LR rule.

Port of ``pfn_tpu/utils/schedules.py``: the reference's cosine and linear
warmup schedules and its "OpenAI" LR rule. A schedule is a plain function
``schedule(count) -> lr`` of the scheduler count; the train loop steps it
once per epoch, as the reference does, by passing the epoch index.
"""

from __future__ import annotations

import math


def cosine_schedule_with_warmup(base_lr: float, num_warmup_steps: int, num_training_steps: int,
                                num_cycles: float = 0.5):
    """LR rises linearly from 0 to ``base_lr`` over the warmup, then follows
    a cosine decay (the reference's get_cosine_schedule_with_warmup)."""

    def schedule(count) -> float:
        count = float(count)
        if count < num_warmup_steps:
            return base_lr * count / max(1, num_warmup_steps)
        progress = (count - num_warmup_steps) / max(1, num_training_steps - num_warmup_steps)
        return base_lr * max(0.0, 0.5 * (1.0 + math.cos(math.pi * num_cycles * 2.0 * progress)))

    return schedule


def linear_schedule_with_warmup(base_lr: float, num_warmup_steps: int, num_training_steps: int):
    """Linear warmup, then linear decay to 0 (the reference's
    get_linear_schedule_with_warmup)."""

    def schedule(count) -> float:
        count = float(count)
        if count < num_warmup_steps:
            return base_lr * count / max(1, num_warmup_steps)
        return base_lr * max(0.0, (num_training_steps - count) / max(1, num_training_steps - num_warmup_steps))

    return schedule


def get_openai_lr(num_params: int) -> float:
    """Max LR from the parameter count (the reference's rule)."""
    return 0.003239 - 0.0001395 * math.log(num_params)
