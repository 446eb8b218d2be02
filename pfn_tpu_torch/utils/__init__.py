"""Shared utilities: LR schedules, eval-position samplers, spans, tracing
and the debug checks."""

from pfn_tpu_torch.utils.profiling import (
    clear,
    debug_checks_enabled,
    debug_nans,
    pfn_debug_checks,
    recorded,
    recording,
    span,
    trace,
)
from pfn_tpu_torch.utils.samplers import make_eval_pos_weights, uniform_single_eval_pos, weighted_single_eval_pos
from pfn_tpu_torch.utils.schedules import cosine_schedule_with_warmup, get_openai_lr, linear_schedule_with_warmup

__all__ = [
    "clear",
    "debug_checks_enabled",
    "debug_nans",
    "pfn_debug_checks",
    "recorded",
    "recording",
    "span",
    "trace",
    "cosine_schedule_with_warmup",
    "get_openai_lr",
    "linear_schedule_with_warmup",
    "make_eval_pos_weights",
    "uniform_single_eval_pos",
    "weighted_single_eval_pos",
]
