"""K1's weight layouts on the CPU: the general kernel's wgmma layout
(K-major core matrices read through shared-memory descriptors) and the
tuned kernel's mma.sync fragment order, for the five general colour-MLP
shapes the kernel serves and the fox's 32-64-64-3.

`pack_shade_weights` must be undone by `unpack_shade_weights` in either
layout, and a plain reading of the wgmma buffer through the descriptor
arithmetic the kernel uses (csrc/shade.cu: gen_issue / gen_issue_output,
wgmma_desc) must give back the padded bf16 weights exactly, and with them
`mlp_apply`'s bf16 MLP at the reference's shade tolerance (rtol 2e-2 /
atol 2e-3, tests/test_shade_pallas.py).  (The kernel reads a net without
hidden layers in fragment order; its wgmma packing is held here all the
same.)  Nets the general kernel cannot hold go to the wide kernel in
fragment order at any width: those round-trip too, and the launch's word
counts match the buffers.  A packing fault shows here, before the card."""

import numpy as np
import pytest
import torch

from sienerf_torch.ops.mlp import mlp_apply
from sienerf_torch.ops import shade
from sienerf_torch.ops.shade import (
    WGMMA_LBO,
    WGMMA_SBO,
    general_width,
    mlp_for_weights,
    pack_shade_weights,
    shade_mlp_layout,
    unpack_shade_weights,
)

# the general shapes of configs/nerf/ (base_0layer and linear, small and
# base_1layer, base_3layer, big), the widest four-layer net, the fox's, and
# widths the kernel pads (40 -> 64, 256)
SHAPES = {
    "base_0layer": ((32, 3),),
    "small": ((32, 64), (64, 3)),
    "base_3layer": ((32, 64), (64, 64), (64, 64), (64, 3)),
    "big": ((32, 128), (128, 128), (128, 3)),
    "w128x4": ((32, 128), (128, 128), (128, 128), (128, 128), (128, 3)),
    "fox": ((32, 64), (64, 64), (64, 3)),
    "w40": ((32, 40), (40, 40), (40, 3)),
    "w256": ((32, 256), (256, 256), (256, 3)),
}
# nets for the wide kernel (fragment order, width padded to 16)
WIDE = {"w272": ((32, 272), (272, 3)), "w512": ((32, 512), (512, 3)),
        "w288x2": ((32, 288), (288, 288), (288, 3))}
TOL = dict(rtol=2e-2, atol=2e-3)


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _weights(shapes, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(0.0, 1.0 / np.sqrt(a), (a, b)).astype(np.float32))
            for a, b in shapes]


def _descriptor_read(buf: bytes, addr: int, k_pad: int, n_pad: int) -> torch.Tensor:
    """B (k_pad, n_pad) of one layer as the kernel's wgmma reads it: k16
    step kt's descriptor starts at addr + kt * (n_pad / 8) * 256 bytes; in
    it the 8-output group ng lies ng * SBO bytes on, the step's second 8
    inputs LBO bytes on, and a core matrix is 8 rows (outputs) of 16 bytes
    (8 consecutive inputs)."""
    out = torch.empty((k_pad, n_pad), dtype=torch.bfloat16)
    words = torch.frombuffer(bytearray(buf), dtype=torch.int16)
    for kt in range(k_pad // 16):
        start = addr + kt * (n_pad // 8) * 256
        for ng in range(n_pad // 8):
            for kh in range(2):
                core = start + ng * WGMMA_SBO + kh * WGMMA_LBO
                for nn in range(8):
                    at = (core + nn * 16) // 2
                    out[16 * kt + 8 * kh: 16 * kt + 8 * kh + 8, 8 * ng + nn] = \
                        words[at: at + 8].view(torch.bfloat16)
    return out


def _kernel_layers(packed: torch.Tensor, shapes):
    """Every layer's B through the descriptors, at the offsets the general
    kernel gives them: the first layer (32 x W) at 0, hidden layer l at
    64 W + (l - 1) 2 W^2, the output layer (W x 8, or 32 x 8 with no hidden
    layer) after them."""
    n_hidden, width = shade_mlp_layout(shapes)
    w = general_width(width) if n_hidden else 32
    buf = packed.view(torch.int16).numpy().tobytes()
    layers, addr = [], 0
    for i in range(n_hidden + 1):
        k_pad, n_pad = (32 if i == 0 else w), (w if i < n_hidden else 8)
        layers.append(_descriptor_read(buf, addr, k_pad, n_pad))
        addr += k_pad * n_pad * 2
    assert addr == packed.numel() * 2
    return layers


@pytest.mark.parametrize("layout", ["wgmma", "fragment"])
@pytest.mark.parametrize("name", list(SHAPES))
def test_packing_round_trips(name, layout):
    shapes = SHAPES[name]
    ws = _weights(shapes, seed=len(name))
    packed = pack_shade_weights(ws, layout)
    for w, u in zip(ws, unpack_shade_weights(packed, shapes, layout)):
        assert torch.equal(w.to(torch.bfloat16), u)
    nonzero = sum(int((w.to(torch.bfloat16) != 0).sum()) for w in ws)
    assert int((packed != 0).sum()) == nonzero  # the padding is zero


@pytest.mark.parametrize("name", list(SHAPES))
def test_descriptor_reading_gives_the_mlp(name):
    shapes = SHAPES[name]
    ws = _weights(shapes, seed=1 + len(name))
    layers = _kernel_layers(pack_shade_weights(ws, "wgmma"), shapes)
    # exactly the padded bf16 weights, zeros around them
    for b, w in zip(layers, ws):
        pad = torch.zeros(b.shape, dtype=torch.bfloat16)
        pad[: w.shape[0], : w.shape[1]] = w.to(torch.bfloat16)
        assert torch.equal(b, pad)
    # the kernel's MLP on those: f32 sums, relu and bf16 between layers
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(0.0, 1.0, (256, 32)).astype(np.float32))
    h = x.to(torch.bfloat16).float()
    for i, b in enumerate(layers):
        h = h @ b.float()
        if i < len(layers) - 1:
            h = torch.relu(h).to(torch.bfloat16).float()
    torch.testing.assert_close(h[:, :3], mlp_apply(mlp_for_weights(ws), ws, x), **TOL)
    assert bool((h[:, 3:] == 0).all())


def test_general_width_pads_to_the_kernels_instances():
    assert [general_width(w) for w in (16, 48, 64, 80, 128, 144, 256)] == \
        [64, 64, 64, 128, 128, 256, 256]
    with pytest.raises(ValueError, match="256"):
        general_width(272)
    with pytest.raises(ValueError, match="layout"):
        pack_shade_weights(_weights(SHAPES["fox"]), "swizzled")


@pytest.mark.parametrize("name", list(WIDE))
def test_wide_packing_round_trips(name):
    shapes = WIDE[name]
    ws = _weights(shapes, seed=len(name))
    packed = pack_shade_weights(ws, "fragment")
    for w, u in zip(ws, unpack_shade_weights(packed, shapes, "fragment")):
        assert torch.equal(w.to(torch.bfloat16), u)
    # above width 256 the route is the wide kernel, without asking the card
    assert shade._route(shapes, "auto", torch.device("cuda", 0)) == "wide"
    assert shade._route(shapes, "general", torch.device("cuda", 0)) == "wide"


@pytest.mark.parametrize("name,path", [(n, "general") for n in SHAPES]
                         + [(n, "wide") for n in list(SHAPES) + list(WIDE)])
def test_launch_word_counts_match_the_buffers(name, path):
    shapes = {**SHAPES, **WIDE}[name]
    n_hidden, width = shade_mlp_layout(shapes)
    words, kernel_width = shade._words_and_width(shapes, path)
    packed = pack_shade_weights(_weights(shapes), shade._kernel_layout(n_hidden, path))
    assert words == packed.numel() // 2
    assert kernel_width == (general_width(width) if path == "general" and n_hidden else width)
