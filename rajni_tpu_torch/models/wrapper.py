"""``RAJNIViT``: the object facade over :func:`vit_forward` (port of
``rajni_tpu/models/wrapper.py``)::

    model = RAJNIViT("vit_base_patch16_224", schedule)   # on the card
    logits = model(images)                               # [B, 224, 224, 3]
    model.get_last_stats()                               # {"token_counts": [...]}

    # int8: quantized params, dynamic scales, or static ones with act_scales
    model = RAJNIViT("deit_small_patch16_224", schedule, params=quantize_params(p),
                     act_scales=calibrate_act_scales(p, images, cfg, schedule))
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence

import torch

from ..utils.schedule import Schedule, normalize_schedule
from ..utils.timing import require_device
from ..quant import ActScales, attach_act_scales
from .vit import (
    ViTConfig,
    get_config,
    init_params,
    model_stats,
    params_quantized,
    resolve_route,
    route_line,
    tree_to,
    vit_forward,
)


class RAJNIViT:
    """ViT with schedule-driven RAJNI token pruning.

    ``kernels`` is the forward's ``impl`` (``"auto"``, ``"cuda"`` or
    ``"torch"``). ``params`` defaults to :func:`init_params` drawn from
    ``seed``; given params are moved to ``device`` and ``dtype`` (int8
    records of :func:`..quant.quantize_params` keep their int8 weights and
    fp32 scales). ``act_scales`` (:func:`..quant.calibrate_act_scales`)
    selects static int8 scales for quantized params on the kernel route;
    setting ``params`` or ``act_scales`` attaches the scales again
    (:func:`..quant.attach_act_scales`: the int8 attention kernels' operands
    made once, static scales folded in, not on each call), as must a change
    of the weights in place.
    The device defaults to CUDA and raises without a card. ``route`` is
    the route the forward takes, decided before any launch
    (:func:`.vit.resolve_route`: ``"route: torch (C=192 is not a multiple of
    128)"`` where the kernels do not take the config or dtype).
    """

    def __init__(
        self,
        model: str | ViTConfig = "vit_base_patch16_224",
        schedule: Mapping | Sequence | Schedule | None = None,
        params: Any = None,
        dtype: torch.dtype = torch.bfloat16,
        kernels: str = "auto",
        seed: int = 0,
        device="cuda",
        act_scales: ActScales | None = None,
    ):
        self.device = require_device(device)
        self.config = model if isinstance(model, ViTConfig) else get_config(model)
        self.schedule = normalize_schedule(schedule, self.config.depth)
        if params is None:
            gen = torch.Generator().manual_seed(seed)
            params = init_params(gen, self.config, dtype, self.device)
        else:
            params = tree_to(params, dtype=dtype, device=self.device)
        self._params, self._act_scales = params, act_scales
        self._attach()
        self.impl = kernels
        self.route = route_line(*resolve_route(kernels, self.config, params["cls_token"].dtype,
                                               self.device, params_quantized(params)))

    def _attach(self) -> None:
        self._forward_params = attach_act_scales(self._params, self._act_scales)

    @property
    def params(self):
        return self._params

    @params.setter
    def params(self, params) -> None:
        self._params = params
        self._attach()

    @property
    def act_scales(self) -> ActScales | None:
        return self._act_scales

    @act_scales.setter
    def act_scales(self, act_scales: ActScales | None) -> None:
        self._act_scales = act_scales
        self._attach()

    @torch.no_grad()
    def __call__(self, images: torch.Tensor) -> torch.Tensor:
        """``[B, H, W, 3] -> [B, num_classes]`` logits."""
        return vit_forward(
            self._forward_params, images.to(self.device), self.config, self.schedule, self.impl,
            self._act_scales,
        )

    def get_last_stats(self) -> dict:
        """Per-block entry token counts."""
        return model_stats(self.config, self.schedule)
