"""The baselines' host data path of hcmoco_tpu_torch held against
hcmoco_tpu's, bit for bit: the augmentation policies A-E (RGB and CMC's
YDbDr), the jigsaw patch stack, RandAugment (its ops against the reference
golden tests/golden/randaugment_golden.npz, its draws against the JAX
package's), the ImageFolder datasets on a fixture tree written by
data/fixtures.py::make_image_folder_fixture, and `skip_draws`, which a
data-parallel rank takes for the other ranks' rows (the ranks' batches are
the rows of the one-process batch)."""

import os

import numpy as np
import pytest
from PIL import Image

from hcmoco_tpu.data import augment as jax_augment
from hcmoco_tpu.data import randaugment as jax_ra
from hcmoco_tpu.data.contrast_folder import (
    ContrastImageFolder as JaxContrastImageFolder)
from hcmoco_tpu.data.image_folder import (
    ImageFolderDataset as JaxImageFolderDataset)

from hcmoco_tpu_torch.data import augment, randaugment as ra
from hcmoco_tpu_torch.data.contrast_folder import ContrastImageFolder
from hcmoco_tpu_torch.data.fixtures import make_image_folder_fixture
from hcmoco_tpu_torch.data.image_folder import (ImageFolderDataset,
                                                scan_image_folder)
from hcmoco_tpu_torch.data.pipeline import DataSource

HERE = os.path.dirname(__file__)
RA_GOLDEN = np.load(os.path.join(HERE, "golden", "randaugment_golden.npz"))
FILL = (124, 116, 104)
SIZE = 48


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return make_image_folder_fixture(str(tmp_path_factory.mktemp("imgf")),
                                     n_classes=3, n_per_class=3, seed=5)


def images(tree, n=4):
    return [Image.open(p).convert("RGB")
            for p, _ in scan_image_folder(os.path.join(tree, "train"))[0][:n]]


@pytest.mark.parametrize("modal", ["RGB", "CMC"])
@pytest.mark.parametrize("aug", ["A", "B", "C", "D", "E"])
def test_policy_matches_jax_bit_for_bit(tree, aug, modal):
    """Each policy over a sequence of images of different sizes, so every
    draw (crop tries, jitter order, blur, RandAugment) chains through one
    generator; then the draws-only call keeps the generator aligned."""
    imgs = images(tree)
    for bank in (True, False):
        got = augment.build_transform(aug, modal, bank, SIZE, seed=3)
        want = jax_augment.build_transform(aug, modal, bank, SIZE, seed=3)
        for img in imgs:
            a, b = got(img), want(img)
            assert a.dtype == b.dtype == np.float32
            assert a.shape == (SIZE, SIZE, 3)
            np.testing.assert_array_equal(a, b)
        # draws only for an image, then the next image equals JAX's
        assert got(None, (imgs[0].size[1], imgs[0].size[0])) is None
        want(imgs[0])
        np.testing.assert_array_equal(got(imgs[1]), want(imgs[1]))


@pytest.mark.parametrize("modal", ["RGB", "CMC"])
def test_jigsaw_stack_matches_jax(tree, modal):
    imgs = images(tree)
    got = augment.build_jigsaw_transform(modal, seed=4)
    want = jax_augment.build_jigsaw_transform(modal, seed=4)
    for img in imgs:
        a = got(img)
        assert a.shape == (9, 64, 64, 3)
        np.testing.assert_array_equal(a, want(img))
    assert got(None, (imgs[0].size[1], imgs[0].size[0])) is None
    want(imgs[0])
    np.testing.assert_array_equal(got(imgs[2]), want(imgs[2]))


def test_colour_conversions_match_jax():
    arr = RA_GOLDEN["input"]
    np.testing.assert_array_equal(augment.rgb2ydbdr(arr),
                                  jax_augment.rgb2ydbdr(arr))
    np.testing.assert_array_equal(augment.rgb2lab(arr),
                                  jax_augment.rgb2lab(arr))


def test_randaugment_ops_match_reference_golden():
    img = Image.fromarray(RA_GOLDEN["input"])
    bil = Image.BILINEAR
    outs = {
        "rotate_17.3": ra.rotate(img, 17.3, fill=FILL, resample=bil),
        "shear_x_0.21": ra.shear_x(img, 0.21, fill=FILL, resample=bil),
        "shear_y_-0.13": ra.shear_y(img, -0.13, fill=FILL, resample=bil),
        "translate_x_rel_-0.3": ra.translate_x_rel(img, -0.3, fill=FILL,
                                                   resample=bil),
        "translate_y_rel_0.22": ra.translate_y_rel(img, 0.22, fill=FILL,
                                                   resample=bil),
        "translate_x_abs_31": ra.translate_x_abs(img, 31, fill=FILL,
                                                 resample=bil),
        "solarize_128": ra.solarize(img, 128),
        "solarize_add_77": ra.solarize_add(img, 77),
        "posterize_2": ra.posterize(img, 2),
        "equalize": ra.equalize(img),
        "auto_contrast": ra.auto_contrast(img),
        "invert": ra.invert(img),
        "color_1.54": ra.enhance_color(img, 1.54),
        "contrast_0.1": ra.enhance_contrast(img, 0.1),
        "brightness_1.9": ra.enhance_brightness(img, 1.9),
        "sharpness_0.28": ra.enhance_sharpness(img, 0.28),
    }
    assert set(outs) | {"input"} == set(RA_GOLDEN)
    for k, out in outs.items():
        np.testing.assert_array_equal(np.asarray(out), RA_GOLDEN[k], k)


@pytest.mark.parametrize("config,cmc", [("rand-n2-m10-mstd0.5", False),
                                        ("rand-n2-m10-mstd0.5", True),
                                        ("rand-n3-m7-w0", False)])
def test_randaugment_draws_match_jax(config, cmc):
    """Forty images through the port's and the JAX package's RandAugment
    from the same generator seed: every op choice, magnitude and
    resampling filter the same, so the images are equal."""
    img = Image.fromarray(RA_GOLDEN["input"])
    got = ra.rand_augment_transform(config, 100, FILL, use_cmc=cmc)
    want = jax_ra.rand_augment_transform(config, 100, FILL, use_cmc=cmc)
    assert got.transforms == want.transforms
    r1, r2 = np.random.default_rng(6), np.random.default_rng(6)
    for _ in range(40):
        np.testing.assert_array_equal(np.asarray(got(img, r1)),
                                      np.asarray(want(img, r2)))
    assert got(None, r1) is None
    want(img, r2)
    assert r1.random() == r2.random()


@pytest.mark.parametrize("train", [True, False])
def test_image_folder_dataset_matches_jax(tree, train):
    root = os.path.join(tree, "train" if train else "val")
    got = ImageFolderDataset(root, SIZE, train=train, seed=2)
    want = JaxImageFolderDataset(root, SIZE, train=train, seed=2)
    assert got.samples == want.samples and got.classes == want.classes
    order = [3, 0, 5, 3, 1] if train else list(range(len(want)))
    for i in order:
        a, b = got[i], want[i]
        assert a.keys() == b.keys()
        for k in b:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], k)
    if train:  # skip_draws consumes one sample's draws
        got.skip_draws(2)
        want[2]
        np.testing.assert_array_equal(got[4]["rgbd"], want[4]["rgbd"])


@pytest.mark.parametrize("kw", [
    dict(aug="A", modal="RGB"),
    dict(aug="B", modal="RGB", two_crop=True, use_memory_bank=False),
    dict(aug="D", modal="RGB", two_crop=True, jigsaw=True,
         use_memory_bank=False),
    dict(aug="C", modal="CMC", jigsaw=True),
    dict(aug="E", modal="CMC", two_crop=True, use_memory_bank=False),
])
def test_contrast_image_folder_matches_jax(tree, kw):
    root = os.path.join(tree, "train")
    got = ContrastImageFolder(root, size=SIZE, seed=1, **kw)
    want = JaxContrastImageFolder(root, size=SIZE, seed=1, **kw)
    for i in (0, 4, 4, 8):
        a, b = got[i], want[i]
        assert a.keys() == b.keys()
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], k)
    got.skip_draws(6)
    want[6]
    a, b = got[2], want[2]
    for k in b:
        np.testing.assert_array_equal(a[k], b[k], k)


@pytest.mark.parametrize("two_crop,jigsaw", [(True, False), (False, True)])
def test_ranks_decode_their_rows_of_the_one_process_batch(tree, two_crop,
                                                          jigsaw):
    """Two ranks' DataSources (rows 0-2 and 3-5 of a global batch of 6,
    the other rank's rows skipped) against one process's, three batches,
    one decode thread."""
    root = os.path.join(tree, "train")
    kw = dict(aug="B", modal="RGB", two_crop=two_crop, jigsaw=jigsaw,
              size=SIZE, seed=0)
    weights = np.ones(9)

    def batches(rows):
        src = DataSource(ContrastImageFolder(root, **kw), 6, weights,
                         seed=0, num_workers=1, rows=rows)
        it = iter(src)
        out = [next(it) for _ in range(3)]
        it.close()
        return out

    one = batches(None)
    ranks = [batches(list(range(3))), batches(list(range(3, 6)))]
    for s in range(3):
        for k in one[s]:
            np.testing.assert_array_equal(
                np.concatenate([ranks[0][s][k], ranks[1][s][k]]),
                one[s][k], k)
