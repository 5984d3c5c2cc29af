"""FLOP accounting for ViT forwards under a pruning schedule, and MFU
against the dense bf16 peak of the H100 in use.

``flops_per_image`` is the JAX package's accounting (``rajni_tpu/utils/
flops.py``): matmul FLOPs only (2 per MAC); scoring, selection and gather
are excluded.
"""

from __future__ import annotations

from ..models.vit import ViTConfig

# Dense bf16 tensor-core peak (TFLOP/s) and memory rate (TB/s), NVIDIA data
# sheets, at the full power limit.
H100_PEAKS = {
    "sxm": (989.0, 3.35),
    "pcie": (756.0, 2.0),
}


def h100_variant(device_name: str) -> str:
    """``"sxm"`` or ``"pcie"`` from ``torch.cuda.get_device_name()``;
    raises for any other card."""
    if "H100" in device_name:
        if "PCIe" in device_name:
            return "pcie"
        if "SXM" in device_name or "HBM3" in device_name:
            return "sxm"
    raise ValueError(f"no peak rates known for {device_name!r}")


def device_peaks(device_name: str) -> tuple[float, float]:
    """``(bf16 TFLOP/s, TB/s)`` of the named H100 SKU."""
    return H100_PEAKS[h100_variant(device_name)]


# Dense int8 tensor-core peak (TOP/s), NVIDIA data sheets: twice the bf16 rate.
H100_INT8_TOPS = {"sxm": 1979.0, "pcie": 1513.0}


def device_int8_peak(device_name: str) -> float:
    """Dense int8 TOP/s of the named H100 SKU."""
    return H100_INT8_TOPS[h100_variant(device_name)]


def flops_per_image(
    config: ViTConfig,
    token_counts: list[int] | None = None,
    final_count: int | None = None,
) -> float:
    """Forward matmul FLOPs per image. Stock block at N: ``24·N·C² +
    4·N²·C``; pruned block N→K: ``6·N·C² + 18·K·C² + 4·K²·C``; plus the
    patch embedding and the head. ``token_counts`` is the entry trace."""
    C = config.embed_dim
    if token_counts is None:
        token_counts = [config.num_tokens] * config.depth
    if len(token_counts) != config.depth:
        raise ValueError(
            f"token_counts has {len(token_counts)} entries for depth {config.depth}"
        )
    n0 = config.num_tokens
    flops = 2.0 * (n0 - 1) * config.patch_size**2 * config.in_chans * C
    exits = list(token_counts[1:]) + [
        token_counts[-1] if final_count is None else final_count
    ]
    for n_in, n_out in zip(token_counts, exits):
        if n_out == n_in:
            flops += 24.0 * n_in * C * C + 4.0 * n_in**2 * C
        else:
            flops += 6.0 * n_in * C * C + 18.0 * n_out * C * C + 4.0 * n_out**2 * C
    flops += 2.0 * C * config.num_classes
    return flops


def mfu(
    config: ViTConfig, token_counts: list[int] | None, img_per_s: float,
    device_name: str,
) -> float:
    """Achieved matmul FLOP/s over the named H100's dense bf16 peak.

    An int8 forward is held to the same bf16 peak, as the JAX suite holds
    its int8 rows (``scripts/bench_suite.py:215-217``), so that the bf16 and
    int8 figures share a denominator; with int8 products at twice the bf16
    rate it can exceed 1."""
    peak_tflops, _ = device_peaks(device_name)
    return flops_per_image(config, token_counts) * img_per_s / (peak_tflops * 1e12)


def train_mfu(
    config: ViTConfig, token_counts: list[int] | None, img_per_s: float,
    device_name: str,
) -> float:
    """Training-step MFU (``rajni_tpu/utils/flops.py:train_mfu``): three times
    the forward's matmul FLOPs (the forward, and the backward's two products
    per forward product) times img/s, over the named H100's dense bf16 peak.
    The optimizer update is elementwise and not counted."""
    return 3.0 * mfu(config, token_counts, img_per_s, device_name)
