"""rajni_tpu_torch: RAJNI token-pruning ViT inference in PyTorch, with
hand-written CUDA kernels for the NVIDIA H100.

The PyTorch/CUDA port of ``rajni_tpu`` (which stays the reference and is
never imported here). Public names mirror the JAX package's.
"""

from .eval import evaluate_model
from .models.vit import (
    VARIANTS,
    ViTConfig,
    get_config,
    init_params,
    model_stats,
    vit_forward,
)
from .models.wrapper import RAJNIViT
from .ops.attention import attention, pruned_attention
from .ops.importance import compute_importance
from .ops.pruning import gather_tokens, keep_count, select_tokens
from .params.from_jax import params_from_numpy
from .quant import ActScales, calibrate_act_scales, quantize_params
from .utils.flops import flops_per_image, mfu
from .utils.schedule import (
    REFERENCE_SCHEDULE,
    PruneSpec,
    load_schedule,
    normalize_schedule,
    schedule_to_dict,
    token_count_trace,
)

__all__ = [
    "ActScales",
    "REFERENCE_SCHEDULE",
    "RAJNIViT",
    "VARIANTS",
    "ViTConfig",
    "PruneSpec",
    "attention",
    "calibrate_act_scales",
    "compute_importance",
    "evaluate_model",
    "flops_per_image",
    "gather_tokens",
    "get_config",
    "init_params",
    "keep_count",
    "load_schedule",
    "mfu",
    "model_stats",
    "normalize_schedule",
    "params_from_numpy",
    "pruned_attention",
    "quantize_params",
    "schedule_to_dict",
    "select_tokens",
    "token_count_trace",
    "vit_forward",
]
