"""The App's display path on the CPU: the 8-bit conversion's plain version
(``ops/display.py``) against ``utils/image.to_uint8`` bit for bit, and the
two-buffer pipeline (``utils/image.py:Display``) that hands a sink each
finished frame one frame later.  The CUDA kernel is held to the same
cases on the card in ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from opengl_raytracer_torch.ops import display
from opengl_raytracer_torch.utils import profiling
from opengl_raytracer_torch.utils.image import Display, to_uint8


def _around(values, ulps: int = 4) -> np.ndarray:
    """``values`` as float32 with the ``ulps`` floats on either side."""
    v = np.asarray(values, np.float32)
    out = [v]
    up, down = v.copy(), v.copy()
    for _ in range(ulps):
        up = np.nextafter(up, np.float32(np.inf))
        down = np.nextafter(down, np.float32(-np.inf))
        out += [up, down]
    return np.concatenate(out)


def conversion_cases() -> dict:
    """Named float32 inputs: below 0, above 1, exactly 0 and 1, every step
    k / 255 and every half step (k + 0.5) / 255 with their neighbours
    (some of which multiply to k + 0.5 exactly: ties, rounded to even),
    and random values over [-0.5, 1.5]."""
    k = np.arange(256, dtype=np.float64)
    halves = _around((k[:255] + 0.5) / 255.0)
    return {
        "out_of_range": np.array([-np.inf, -1e30, -2.0, -1.0, -1e-30, -0.0,
                                  1.0 + 2**-23, 1.5, 2.0, 1e30, np.inf],
                                 np.float32),
        "zero_and_one": _around([0.0, 1.0]),
        "steps": _around(k / 255.0),
        "half_steps": halves,
        "random": np.random.default_rng(7).uniform(
            -0.5, 1.5, 100_000).astype(np.float32),
    }


def as_frame(values: np.ndarray) -> np.ndarray:
    """The values as an (H, W, 3) float32 frame (zero-padded)."""
    n = -(-values.size // 3)
    flat = np.zeros(3 * n, np.float32)
    flat[:values.size] = values
    return flat.reshape(n, 1, 3)


def test_half_steps_hold_ties():
    """The half-step cases reach exact ties k + 0.5 after the float32
    product, so the rounding rule is exercised."""
    v = conversion_cases()["half_steps"]
    prod = (v * np.float32(255.0)).astype(np.float32)
    ties = prod[prod == np.floor(prod) + np.float32(0.5)]
    assert len(np.unique(ties)) >= 100


@pytest.mark.parametrize("case", sorted(conversion_cases()))
def test_plain_conversion_matches_to_uint8(case):
    img = as_frame(conversion_cases()[case])
    got = display.to_uint8_plain(torch.from_numpy(img))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), to_uint8(img))
    out = torch.empty(img.shape, dtype=torch.uint8)
    display.to_uint8(torch.from_numpy(img), out)
    np.testing.assert_array_equal(out.numpy(), to_uint8(img))


def test_conversion_refuses_bad_input():
    img = torch.zeros(4, 5, 3)
    out = torch.empty(4, 5, 3, dtype=torch.uint8)
    with pytest.raises(ValueError, match="dtype"):
        display.to_uint8(img.double(), out)
    with pytest.raises(ValueError, match="dtype"):
        display.to_uint8(img, out.int())
    with pytest.raises(ValueError, match="contiguous"):
        display.to_uint8(img.transpose(0, 1), out)
    with pytest.raises(ValueError, match="shape"):
        display.to_uint8(img, out[:3])
    with pytest.raises(ValueError, match="shape"):
        display.to_uint8(img[..., :2].contiguous(), out[..., :2].contiguous())


def test_display_presents_each_frame_once_and_one_late():
    d = Display(4, 5, "cpu")
    shown = []

    def sink(image, frame_count):
        shown.append((image.clone(), frame_count))

    assert not d.present(sink)  # nothing started yet
    frames = [torch.rand(4, 5, 3) * 1.2 - 0.1 for _ in range(3)]
    before = profiling.counts().get("app.presented", 0)
    for n, f in enumerate(frames):
        d.start(f, n + 1)
        assert d.present(sink)
        assert not d.present(sink)  # each frame once
    assert profiling.counts()["app.presented"] == before + 3
    for (image, count), f, n in zip(shown, frames, range(3)):
        assert count == n + 1
        np.testing.assert_array_equal(image.numpy(), to_uint8(f.numpy()))


def test_display_alternates_and_keeps_the_held_buffer():
    """Two host buffers in turn; the one a sink was handed stays unchanged
    through the next start, until the next present."""
    d = Display(4, 5, "cpu")
    held = []

    def sink(image, frame_count):
        if held:
            buf, kept = held[-1]
            assert torch.equal(buf, kept)  # survived the next start
        held.append((image, image.clone()))

    for n in range(6):
        d.start(torch.full((4, 5, 3), n / 10.0), n)
        d.present(sink)
    ptrs = [buf.data_ptr() for buf, _ in held]
    assert len(set(ptrs)) == 2
    assert all(a != b for a, b in zip(ptrs, ptrs[1:]))
    # a start without a present writes the slot not held
    d.start(torch.ones(4, 5, 3), 9)
    buf, kept = held[-1]
    assert torch.equal(buf, kept)
