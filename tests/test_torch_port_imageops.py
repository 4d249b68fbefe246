"""The port's host frame transforms against the JAX package's on the
CPU: torchvision's RandomResizedCrop box search, including its centre-crop
fallback; the eval Resize and the train crop-and-flip of a JPEG file,
uint8 and normalised float, each on the native libjpeg path and on the PIL
path (the library forced off in both packages, as on a machine without
``libjpeg.so.62``); and the transforms of a decoded array (frames
streamed from a container)."""

import numpy as np
import pytest
import torch

from multimodal_clinical_tpu.data import imageops as jax_imageops
from multimodal_clinical_tpu.utils import native as jax_native

from multimodal_clinical_tpu_torch.benchmarks import disk_fixture
from multimodal_clinical_tpu_torch.data import imageops
from multimodal_clinical_tpu_torch.utils import native

torch.set_num_threads(2)


@pytest.fixture(params=["native", "pil"])
def host_lib(request, monkeypatch):
    if request.param == "native":
        if not jax_native.available():
            pytest.skip("native/libfastdata.so does not load here")
        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.setattr(native, "_tried", False)
        assert native.available()
    else:
        for module in (native, jax_native):
            monkeypatch.setattr(module, "_lib", None)
            monkeypatch.setattr(module, "_tried", True)
    return request.param


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    """Paths of JPEGs at three geometries: landscape, portrait, and a
    strip whose aspect no 10-attempt search fits."""
    root = tmp_path_factory.mktemp("frames")
    paths = []
    for k, size in enumerate([(96, 54), (30, 64), (200, 9)]):
        path = root / f"f{k}.jpg"
        path.write_bytes(disk_fixture.jpeg_pool(k, 1, size, 92)[0])
        paths.append(str(path))
    return paths


@pytest.mark.parametrize("size", [(640, 360), (480, 360), (1, 1), (3, 500),
                                  (500, 3), (224, 224)])
def test_random_resized_crop_box_matches(size):
    for seed in range(40):
        box = imageops.random_resized_crop_box(
            np.random.default_rng(seed), *size)
        assert box == jax_imageops.random_resized_crop_box(
            np.random.default_rng(seed), *size)
        left, top, right, bottom = box
        assert 0 <= left < right <= size[0] and 0 <= top < bottom <= size[1]


def test_quantize_and_normalize_match():
    x = np.random.default_rng(0).uniform(-0.1, 1.1, (5, 7, 3)).astype(
        np.float32)
    np.testing.assert_array_equal(imageops._quantize_u8(x),
                                  jax_imageops._quantize_u8(x))
    np.testing.assert_array_equal(imageops._normalize(x),
                                  jax_imageops._normalize(x))


def test_eval_frames_match(frames, host_lib):
    for path in frames:
        for size in (224, 33):
            got = imageops.load_frame_eval_u8(path, size)
            assert got.dtype == np.uint8 and got.shape == (size, size, 3)
            np.testing.assert_array_equal(
                got, jax_imageops.load_frame_eval_u8(path, size))
        np.testing.assert_array_equal(imageops.load_frame_eval(path),
                                      jax_imageops.load_frame_eval(path))


def test_train_frames_match(frames, host_lib):
    """The same crop boxes and flips from the same Generator, and the
    Generator left in the same state after each frame."""
    for path in frames:
        for seed in range(6):
            rng, ref = (np.random.default_rng(seed),
                        np.random.default_rng(seed))
            got = imageops.load_frame_train_u8(path, rng)
            np.testing.assert_array_equal(
                got, jax_imageops.load_frame_train_u8(path, ref))
            assert rng.random() == ref.random()
            np.testing.assert_array_equal(
                imageops.load_frame_train(path, np.random.default_rng(seed)),
                jax_imageops.load_frame_train(path,
                                              np.random.default_rng(seed)))


def test_array_transforms_match():
    img = np.random.default_rng(1).integers(0, 256, (36, 52, 3),
                                            dtype=np.uint8)
    for seed in range(6):
        rng, ref = np.random.default_rng(seed), np.random.default_rng(seed)
        np.testing.assert_array_equal(
            imageops.transform_frame_train_u8(img, rng),
            jax_imageops.transform_frame_train_u8(img, ref))
        assert rng.random() == ref.random()
    np.testing.assert_array_equal(imageops.transform_frame_eval_u8(img, 50),
                                  jax_imageops.transform_frame_eval_u8(img,
                                                                       50))
