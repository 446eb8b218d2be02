"""Shared utilities: LR schedules, eval-position samplers, step timers."""

from pfn_tpu_torch.utils.profiling import ChannelStats, StepTimers
from pfn_tpu_torch.utils.samplers import make_eval_pos_weights, uniform_single_eval_pos, weighted_single_eval_pos
from pfn_tpu_torch.utils.schedules import cosine_schedule_with_warmup, get_openai_lr, linear_schedule_with_warmup

__all__ = [
    "ChannelStats",
    "StepTimers",
    "cosine_schedule_with_warmup",
    "get_openai_lr",
    "linear_schedule_with_warmup",
    "make_eval_pos_weights",
    "uniform_single_eval_pos",
    "weighted_single_eval_pos",
]
