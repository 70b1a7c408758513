"""The frozen yardstick equals the program's arithmetic at the commit it
was copied from."""

import pytest

from portbench import frozen, run
from portbench.reference import network


@pytest.mark.parametrize("name,flops,params", [
    ("squeezedet_kitti", 10_649_089_152, 2_082_120),
    ("squeezedetplus_kitti", 77_246_240_640, 7_021_640)])
def test_flops_equal_the_port_tracer(name, flops, params):
    from squeezedet_torch.config import config_for_net
    from squeezedet_torch.models import squeezedet, squeezedet_plus
    import torch
    cfg = run.load_json("portbench", "configs", name + ".json")
    assert frozen.forward_flops(cfg) == flops
    pcfg = config_for_net(cfg["net"])
    net = {"squeezeDet": squeezedet.SqueezeDet,
           "squeezeDet+": squeezedet_plus.SqueezeDetPlus}[cfg["net"]](
        pcfg, device="cpu", generator=torch.Generator().manual_seed(0))
    assert sum(f for _, f in net.tracer.flop_counter) == flops
    assert net.tracer.total_params() == params == cfg["params"]
    assert (net.tracer.height, net.tracer.width) == network(cfg).grid(cfg)


@pytest.mark.parametrize("h,w", [(384, 1248), (375, 1242), (64, 128),
                                 (17, 33)])
def test_k1_geometry_equals_the_port(h, w):
    from squeezedet_torch.ops import fused_frontend
    assert frozen.k1_geometry(h, w) == fused_frontend.geometry(h, w)[:4]


def test_bounds():
    ms, what = frozen.k1_bound(128, 384, 1248)
    assert what == "bytes" and ms == pytest.approx(0.25635, rel=1e-4)
    ms, what = frozen.k2_bound(20, 3, 384, 72, 24, 78)
    assert what == "operations"


def test_k2_routed_convs_follow_the_port_rule():
    """The calls the reader bounds are those the "1x1" route sends to K2
    in a training forward of the port."""
    import torch
    from squeezedet_torch.config import config_for_net
    from squeezedet_torch.models import get_model, layers
    cfg = run.load_json("portbench", "configs", "squeezedet_kitti.json")
    routed = network(cfg).k2_routed(cfg)
    seen = []
    orig = layers.filter_grad_eligible

    def spy(x, weight):
        ok = orig(x, weight)
        if ok:
            seen.append((weight.shape[2], weight.shape[1], weight.shape[0],
                         x.shape[1], x.shape[2]))
        return ok
    det = get_model("squeezeDet", config_for_net("squeezeDet").replace(
        compute_dtype="bfloat16"), device="cpu")
    prev = layers.filter_grad_mode()
    layers.set_filter_grad("1x1")
    try:
        layers.filter_grad_eligible = spy
        with torch.no_grad():
            det(torch.zeros(1, 384, 1248, 3), train=False)
    finally:
        layers.filter_grad_eligible = orig
        layers.set_filter_grad(prev)
    # the port takes a fire's squeeze over its two input halves apart,
    # one after the other
    assert len(seen) == 2 * len(routed)
    whole = [(a[0], a[1] + b[1]) + a[2:] for a, b in zip(seen[::2],
                                                         seen[1::2])]
    assert whole == routed
