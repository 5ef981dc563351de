"""Counter-free sequential RNG, bit-compatible with the reference shader.

The reference advances a per-pixel uint32 state with an LCG and applies a
PCG-style shift/xor scramble; the output is mapped to **[-1, 1]**
(reference: fragment.glsl:206-218).  The per-pixel seed is
``x*1973 ^ y*9277 ^ frameNumber*1664525`` followed by three warm-up draws
(fragment.glsl:390-394).

States are uint32 values held in ``torch.int64`` tensors and masked to 32
bits after every product or sum: ``torch.uint32`` has no add, shift or
compare on the CPU.  Every product below stays under 2^63, so nothing
overflows and each state is bit-identical to the JAX package's uint32 math.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
_LCG_MUL = 747796405
_LCG_ADD = 2891336453
_MIX_MUL = 277803737
# float32(4294967295.0) rounds to 4294967296.0, matching the GLSL literal.
_INV_SCALE = 4294967296.0


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2^32`` for x < 2^32 and any c < 2^32, in int64 without
    overflow: the constant is split into 16-bit halves."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & MASK32


def seed_pixels(px: torch.Tensor, py: torch.Tensor, frame_number) -> torch.Tensor:
    """Per-pixel seed (fragment.glsl:390).  px/py are int tensors; py is in
    GL convention (0 = bottom row); frame_number an int or an int tensor."""
    x = ((px.to(torch.int64) & MASK32) * 1973) & MASK32
    y = ((py.to(torch.int64) & MASK32) * 9277) & MASK32
    if isinstance(frame_number, torch.Tensor):
        f = _mul32(frame_number.to(torch.int64) & MASK32, 1664525)
    else:
        f = ((int(frame_number) & MASK32) * 1664525) & MASK32
    return x ^ y ^ f


def random_value(state: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One draw: returns (new_state, float32 value in [-1, 1])
    (fragment.glsl:206-218)."""
    state = (state * _LCG_MUL + _LCG_ADD) & MASK32
    t = state >> ((state >> 28) + 4)
    result = ((t ^ state) * _MIX_MUL) & MASK32
    result = (result >> 22) ^ result
    value = result.to(torch.float32) / _INV_SCALE * 2.0 - 1.0
    return state, value


def warmup(state: torch.Tensor, n: int = 3) -> torch.Tensor:
    """The reference's three warm-up draws after seeding
    (fragment.glsl:392-394)."""
    for _ in range(n):
        state = (state * _LCG_MUL + _LCG_ADD) & MASK32
    return state


def advance_constants(n: int) -> tuple[int, int]:
    """(A_n, C_n) such that ``s * A_n + C_n mod 2^32`` equals n sequential
    LCG state advances (the output scramble never feeds the state)."""
    a, c = 1, 0
    for _ in range(int(n)):
        a = (a * _LCG_MUL) & MASK32
        c = (c * _LCG_MUL + _LCG_ADD) & MASK32
    return a, c


def advance_n(state: torch.Tensor, n: int) -> torch.Tensor:
    """State after ``n`` draws, without producing the values."""
    a_n, c_n = advance_constants(n)
    return (_mul32(state, a_n) + c_n) & MASK32


def random_vec3(state: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Three sequential draws -> (new state, (..., 3) float32 values), in
    the component order of ``diffuse`` (fragment.glsl:221)."""
    state, r0 = random_value(state)
    state, r1 = random_value(state)
    state, r2 = random_value(state)
    return state, torch.stack([r0, r1, r2], dim=-1)
