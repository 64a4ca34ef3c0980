"""Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates at the
700 W limit) and the operations and bytes of the kernels the cells time.

Bytes count each input byte read once and each output byte written once;
data-dependent work is counted as this run's inputs need it.
"""

from __future__ import annotations

HBM_BYTES_S = 3.35e12
BF16_FLOPS = 989e12      # tensor cores, dense
F32_FLOPS = 67e12        # outside the tensor cores
K2_FLOPS_PER_SAMPLE = 30  # affine map, texel select, alpha (one exp), carry


def mlp_flops(dims) -> int:
    """Multiply-adds of a bias-free MLP's layers, as flops, for one input
    row: dims are the (d_in, d_out) matrix shapes."""
    return 2 * sum(a * b for a, b in dims)


def k1_bound_s(n_rows: int, kept: int, n_cascades: int, resolution: int,
               rgb_dims, n_scales: int) -> float:
    """K1, one shade of the bake: a kept vertex reads its 32-byte row, a
    culled one its 2-byte sentinel field; every vertex writes 4 bf16
    channels; the colour MLP runs on the kept vertices on the bf16 tensor
    cores.  -> the larger of the bytes and the flops bounds, seconds."""
    rv3 = (resolution + 1) ** 3
    nbytes = (kept * 32 + (n_rows - kept) * 2 + n_cascades * rv3 * 8 + n_scales * 4 + 12
              + sum(a * b for a, b in rgb_dims) * 2)
    return max(nbytes / HBM_BYTES_S, kept * mlp_flops(rgb_dims) / BF16_FLOPS)


def k2_bound_s(samples: int, texels: int, n_cascades: int, resolution: int,
               hi: int, wi: int) -> float:
    """K2, one composite: the distinct 8-byte texels that live samples read,
    the slab schedule, the gnomonic coordinates and six f32 output maps at
    the HBM rate, or K2_FLOPS_PER_SAMPLE a live sample at the f32 rate."""
    nbytes = texels * 8 + n_cascades * resolution * 5 * 4 + (hi + wi) * 4 + hi * wi * 6 * 4
    return max(nbytes / HBM_BYTES_S, samples * K2_FLOPS_PER_SAMPLE / F32_FLOPS)
