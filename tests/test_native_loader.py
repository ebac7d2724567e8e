"""Native C++ loader: build, decode parity vs cv2, parallel gather."""

import numpy as np
import pytest

from pose3d_tpu.data.native_loader import (
    NativeImageLoader,
    native_available,
    parallel_gather,
)

cv2 = pytest.importorskip("cv2")


@pytest.fixture
def jpeg_dir(tmp_path, rng):
    paths = []
    for i in range(6):
        img = (rng.random((100 + 10 * i, 120, 3)) * 255).astype(np.uint8)
        p = tmp_path / f"{i:04d}.jpg"
        cv2.imwrite(str(p), cv2.cvtColor(img, cv2.COLOR_RGB2BGR),
                    [cv2.IMWRITE_JPEG_QUALITY, 95])
        paths.append(p)
    return paths


from pose3d_tpu.data.native_build import ensure_built  # noqa: E402

# build is explicit now (no compiler side effects at decode time)
ensure_built()


class TestNativeLoader:
    def test_builds(self):
        assert native_available(), "native loader failed to build"

    def test_decode_matches_cv2(self, jpeg_dir):
        loader = NativeImageLoader(image_size=64)
        got = loader.decode_batch(jpeg_dir)
        assert got.shape == (6, 64, 64, 3) and got.dtype == np.float32
        for i, p in enumerate(jpeg_dir):
            img = cv2.cvtColor(cv2.imread(str(p)), cv2.COLOR_BGR2RGB)
            want = cv2.resize(img, (64, 64)).astype(np.float32) / 256.0
            # same JPEG decode, both bilinear resizes; small interpolation
            # differences allowed
            assert np.abs(got[i] - want).mean() < 0.01
            assert np.abs(got[i] - want).max() < 0.15

    def test_missing_file_zero_filled(self, jpeg_dir, tmp_path):
        loader = NativeImageLoader(image_size=32)
        got = loader.decode_batch([jpeg_dir[0], tmp_path / "nope.jpg"])
        assert got[0].max() > 0
        np.testing.assert_array_equal(got[1], 0.0)

    def test_value_range(self, jpeg_dir):
        loader = NativeImageLoader(image_size=48)
        got = loader.decode_batch(jpeg_dir)
        assert got.min() >= 0.0 and got.max() < 1.0  # /256 convention


class TestParallelGather:
    def test_matches_numpy(self, rng):
        src = rng.random((1000, 17, 3)).astype(np.float32)
        idx = rng.integers(0, 1000, 256)
        got = parallel_gather(src, idx)
        np.testing.assert_array_equal(got, src[idx])

    def test_large_rows(self, rng):
        src = rng.random((64, 32, 32, 3)).astype(np.float32)
        idx = rng.permutation(64)
        got = parallel_gather(src, idx, n_threads=4)
        np.testing.assert_array_equal(got, src[idx])
