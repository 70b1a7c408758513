"""The port's configs and anchors equal the JAX package's."""

import dataclasses

import numpy as np
import pytest

import squeezedet_torch.config as tc
from squeezedet_tpu.config import kitti as jk
from squeezedet_tpu.config import anchors as ja


def _assert_same_config(got, want):
    assert [f.name for f in dataclasses.fields(got)] == \
        [f.name for f in dataclasses.fields(want)]
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and np.array_equal(g, w), f.name
        else:
            assert g == w, f.name
    assert (got.classes, got.anchors, got.head_channels) == \
        (want.classes, want.anchors, want.head_channels)
    np.testing.assert_array_equal(got.bgr_means_array(),
                                  want.bgr_means_array())


@pytest.mark.parametrize("make", [
    lambda m: m.kitti_squeezedet_config(),
    lambda m: m.tiny_test_config(),
    lambda m: m.tiny_test_config(image_width=160, image_height=64,
                                 batch_size=3),
    lambda m: m.custom_kitti_config("squeezeDet", 624, 192),
    lambda m: m.config_for_net_at("squeezeDet", 640, 0),
    lambda m: m.kitti_squeezedet_plus_config(),
    lambda m: m.kitti_vgg16_config(),
    lambda m: m.kitti_res50_config(),
    lambda m: m.kitti_model_config(),
    lambda m: m.tiny_test_config("resnet50"),
    lambda m: m.custom_kitti_config("vgg16", 624, 192),
], ids=["flagship", "tiny", "tiny_160x64", "custom_624x192",
        "config_for_net_at_640", "squeezedet_plus", "vgg16", "res50",
        "model", "tiny_resnet50", "custom_vgg16_624x192"])
def test_config_matches_jax(make):
    _assert_same_config(make(tc.kitti), make(jk))


@pytest.mark.parametrize("net", ["squeezeDet", "squeezeDet+", "vgg16",
                                 "resnet50"])
def test_config_for_net_matches_jax(net):
    from squeezedet_tpu.config import config_for_net
    _assert_same_config(tc.config_for_net(net), config_for_net(net))


@pytest.mark.parametrize("net", ["squeezeDet", "squeezeDet+", "vgg16",
                                 "resnet50"])
def test_voc_config_for_net_matches_jax(net):
    from squeezedet_tpu.config.voc import voc_config_for_net
    _assert_same_config(tc.voc_config_for_net(net), voc_config_for_net(net))
    _assert_same_config(tc.voc_config_for_net(net, 512, 384),
                        voc_config_for_net(net, 512, 384))


@pytest.mark.parametrize("net", ["squeezeDet", "squeezeDet+", "vgg16",
                                 "resnet50"])
def test_grid_for_net_matches_jax(net):
    for size in (64, 96, 375, 384, 1242, 1248):
        assert tc.grid_for_net(net, size) == jk.grid_for_net(net, size)


def test_anchor_grid_and_tables_match_jax():
    np.testing.assert_array_equal(tc.SQUEEZEDET_ANCHOR_SHAPES,
                                  ja.SQUEEZEDET_ANCHOR_SHAPES)
    np.testing.assert_array_equal(tc.RESNET50_ANCHOR_SHAPES,
                                  ja.RESNET50_ANCHOR_SHAPES)
    got = tc.make_anchor_grid(1248, 384, 78, 24, tc.SQUEEZEDET_ANCHOR_SHAPES)
    want = ja.make_anchor_grid(1248, 384, 78, 24, ja.SQUEEZEDET_ANCHOR_SHAPES)
    assert got.shape == (16848, 4) and got.dtype == np.float64
    np.testing.assert_array_equal(got, want)
