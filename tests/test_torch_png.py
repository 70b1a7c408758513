"""The port's PNG codec against OpenCV and PIL: ``imread_png`` equals
``cv2.imread`` bit for bit (PNG is lossless) for gray, RGB and RGBA files
and every row filter; ``read_png_size`` equals PIL's header read;
``write_png`` round-trips through ``cv2.imread``."""

import cv2
import numpy as np
import pytest
from PIL import Image

from squeezedet_torch.data import png

FILTERS = {"none": cv2.IMWRITE_PNG_FILTER_NONE,
           "sub": cv2.IMWRITE_PNG_FILTER_SUB,
           "up": cv2.IMWRITE_PNG_FILTER_UP,
           "avg": cv2.IMWRITE_PNG_FILTER_AVG,
           "paeth": cv2.IMWRITE_PNG_FILTER_PAETH,
           "adaptive": cv2.IMWRITE_PNG_ALL_FILTERS}


def _image(shape, seed):
    """Noise with a smooth ramp and a flat box: rows that the adaptive
    filter choice codes with different filters."""
    rs = np.random.RandomState(seed)
    im = rs.randint(0, 256, shape).astype(np.uint8)
    h, w = shape[:2]
    y, x = np.mgrid[:h, :w]
    ramp = ((x * 3 + y * 5) % 256).astype(np.uint8)
    im[h // 3:, :] = ramp[h // 3:, :, None] if im.ndim == 3 else \
        ramp[h // 3:]
    im[2:h // 4, w // 4:w // 2] = 77
    return im


def _row_filters(path):
    return set(png.row_filters(path).tolist())


@pytest.mark.parametrize("channels", [1, 3, 4], ids=["gray", "rgb", "rgba"])
@pytest.mark.parametrize("filt", sorted(FILTERS))
def test_imread_png_equals_cv2(tmp_path, channels, filt):
    shape = (23, 41) if channels == 1 else (23, 41, channels)
    path = str(tmp_path / "im.png")
    cv2.imwrite(path, _image(shape, channels),
                [cv2.IMWRITE_PNG_FILTER, FILTERS[filt]])
    got = png.imread_png(path)
    want = cv2.imread(path, cv2.IMREAD_COLOR)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert png.read_png_size(path) == Image.open(path).size == (41, 23)


def test_adaptive_files_use_every_filter(tmp_path):
    """cv2's adaptive choice codes a KITTI-sized frame with several row
    filters; the decode still equals cv2's."""
    path = str(tmp_path / "kitti.png")
    im = _image((375, 1242, 3), 5)
    cv2.imwrite(path, im, [cv2.IMWRITE_PNG_FILTER,
                           cv2.IMWRITE_PNG_ALL_FILTERS])
    assert len(_row_filters(path)) >= 3
    np.testing.assert_array_equal(png.imread_png(path), cv2.imread(path))


def test_adaptive_write_chooses_libpngs_filters(tmp_path):
    """``filter_type=None`` gives each row the filter libpng's adaptive
    choice gives it (cv2 with ALL_FILTERS), and decodes to the image."""
    im = _image((375, 1242, 3), 6)
    ours, theirs = str(tmp_path / "ours.png"), str(tmp_path / "cv2.png")
    png.write_png(ours, im, filter_type=None)
    cv2.imwrite(theirs, im, [cv2.IMWRITE_PNG_FILTER,
                             cv2.IMWRITE_PNG_ALL_FILTERS])
    np.testing.assert_array_equal(png.row_filters(ours),
                                  png.row_filters(theirs))
    assert len(_row_filters(ours)) >= 3
    np.testing.assert_array_equal(cv2.imread(ours), im)


def test_write_png_round_trips(tmp_path):
    path = str(tmp_path / "w.png")
    im = _image((37, 53, 3), 9)
    png.write_png(path, im)
    np.testing.assert_array_equal(cv2.imread(path), im)
    np.testing.assert_array_equal(png.imread_png(path), im)
    assert _row_filters(path) == {0}
    assert png.read_png_size(path) == (53, 37)


@pytest.mark.parametrize("filter_type", [0, 1, 2, 3, 4],
                         ids=["none", "sub", "up", "avg", "paeth"])
def test_write_png_each_filter_decodes_as_cv2(tmp_path, filter_type):
    """Rows written with one filter each decode to the image, by cv2 and
    by imread_png."""
    path = str(tmp_path / "f.png")
    im = _image((29, 47, 3), 10 + filter_type)
    png.write_png(path, im, filter_type=filter_type)
    assert _row_filters(path) == {filter_type}
    np.testing.assert_array_equal(cv2.imread(path), im)
    np.testing.assert_array_equal(png.imread_png(path), im)


def test_unsupported_and_corrupt_files_name_the_file(tmp_path):
    pal = str(tmp_path / "palette.png")
    Image.fromarray(_image((8, 8, 3), 1)).convert("P").save(pal)
    deep = str(tmp_path / "deep.png")
    cv2.imwrite(deep, np.full((8, 8, 3), 1000, np.uint16))
    for path in (pal, deep):
        with pytest.raises(ValueError, match="unsupported PNG") as e:
            png.imread_png(path)
        assert path in str(e.value)

    good = str(tmp_path / "good.png")
    png.write_png(good, _image((8, 8, 3), 2))
    data = bytearray(open(good, "rb").read())
    data[45] ^= 0xFF  # inside the IDAT payload: its CRC no longer holds
    bad = str(tmp_path / "bad.png")
    open(bad, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="bad CRC"):
        png.imread_png(bad)
    jpeg = str(tmp_path / "x.jpg")
    cv2.imwrite(jpeg, _image((8, 8, 3), 3))
    with pytest.raises(ValueError, match="not a PNG"):
        png.read_png_size(jpeg)
