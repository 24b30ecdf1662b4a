"""``data/resize.py::resize_linear_u8`` byte-equal to ``cv2.resize`` with
its default INTER_LINEAR on uint8 (tolerance 0), over random sizes up and
down, one axis kept, exact halvings (which OpenCV runs as INTER_AREA) and
the served geometry."""

import cv2
import numpy as np
import pytest

from snn_object_detectionddp_tpu_torch.data.resize import resize_linear_u8


def _draws(seed, n):
    rng = np.random.RandomState(seed)
    for _ in range(n):
        src = tuple(int(v) for v in rng.randint(1, 97, 2))
        dst = tuple(int(v) for v in rng.randint(1, 97, 2))
        yield src, dst, int(rng.choice([0, 3, 4])), rng


@pytest.mark.parametrize("seed", range(4))
def test_random_sizes_equal_cv2(seed):
    for (sh, sw), (h, w), ch, rng in _draws(seed, 40):
        img = rng.randint(0, 256, (sh, sw, ch) if ch else (sh, sw)).astype(np.uint8)
        got = resize_linear_u8(img, (h, w))
        want = cv2.resize(img, (w, h))
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want, err_msg=f"{img.shape} -> {(h, w)}")


@pytest.mark.parametrize("src,dst", [
    ((480, 640), (240, 320)),  # exact halving: INTER_AREA inside OpenCV
    ((240, 320), (480, 640)),
    ((600, 800), (480, 640)),
    ((481, 641), (480, 640)),
    ((100, 100), (480, 640)),
    ((480, 640), (48, 64)),
    ((480, 333), (480, 640)),  # one axis kept
    ((37, 640), (480, 640)),
    ((1, 1), (5, 7)),
    ((5, 7), (1, 1)),
])
def test_served_geometries_equal_cv2(src, dst):
    img = np.random.RandomState(sum(src) + sum(dst)).randint(0, 256, src + (3,)).astype(np.uint8)
    np.testing.assert_array_equal(resize_linear_u8(img, dst), cv2.resize(img, dst[::-1]))


def test_same_size_is_a_copy_and_bad_input_raises():
    img = np.arange(24, dtype=np.uint8).reshape(2, 4, 3)
    out = resize_linear_u8(img, (2, 4))
    assert out is not img and np.array_equal(out, img)
    with pytest.raises(ValueError, match="uint8"):
        resize_linear_u8(img.astype(np.float32), (3, 3))
    with pytest.raises(ValueError, match="positive"):
        resize_linear_u8(img, (0, 3))
