"""The port's roofline (``repro_torch/launch/roofline.py``) against the
reference's (``repro/launch/roofline.py``): every function but the HLO
parse, for every arch × input shape; ``roofline_terms`` with the
reference's TPU constants swapped for the H100 SXM's; and those constants
against ``chip_smoke.py``'s ``CARD_RATES``."""
import random
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.configs import INPUT_SHAPES as JSHAPES  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch import roofline as jrl  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro_torch.configs import (INPUT_SHAPES, get_config,  # noqa: E402
                                 list_archs)
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import roofline as trl  # noqa: E402
from repro_torch.launch import specs as tspecs  # noqa: E402
from repro_torch.parallel.comm import Mesh  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
COMBOS = [(a, s) for a in list_archs() for s in INPUT_SHAPES]


def _pair(arch, shape):
    return (jget_config(arch), JSHAPES[shape], get_config(arch),
            INPUT_SHAPES[shape])


def test_the_registries_agree():
    assert list(INPUT_SHAPES) == list(JSHAPES)
    for arch in list_archs():
        jget_config(arch)


@pytest.mark.parametrize("arch,shape", COMBOS)
def test_analytic_terms_match_the_reference(arch, shape):
    jcfg, jshape, cfg, tshape = _pair(arch, shape)
    window = tspecs.serve_window(cfg, tshape)
    assert window == jspecs.serve_window(jcfg, jshape)
    assert trl.probe_units(cfg) == jrl.probe_units(jcfg)
    for n in trl.probe_units(cfg)[0]:
        assert trl.probe_config(cfg, n).n_layers == \
            jrl.probe_config(jcfg, n).n_layers == n
    assert trl.analytic_flops(cfg, tshape, window) == \
        jrl.analytic_flops(jcfg, jshape, window)
    assert trl.model_flops(cfg, tshape) == jrl.model_flops(jcfg, jshape)
    for chips in (1, 256, 512):
        assert trl.analytic_hbm_bytes(cfg, tshape, window, chips) == \
            jrl.analytic_hbm_bytes(jcfg, jshape, window, chips)
    for w in {0, window, 4096}:
        assert trl._decode_cache_bytes(cfg, tshape, w) == \
            jrl._decode_cache_bytes(jcfg, jshape, w)


@pytest.mark.parametrize("op", [*jrl._COLL_OPS, "all-reduce-start", ""])
def test_link_bytes_match_the_reference(op):
    for n in (1, 2, 8, 16):
        for size in (0, 1, 4096, 12345678):
            assert trl._link_bytes(op, size, n) == \
                jrl._link_bytes(op, size, n), (op, size, n)


def test_scale_probe_costs_matches_the_reference_with_negative_deltas():
    rng = random.Random(0)
    keys = ["flops", "bytes", "link_bytes", "link:all-reduce", "class:net"]
    for trial in range(200):
        c1 = {k: rng.uniform(0, 1e12) for k in keys if rng.random() < 0.8}
        c2 = {k: rng.uniform(0, 1e12) for k in keys if rng.random() < 0.8}
        n_units = rng.choice([1, 2, 13.5, 27, 61])
        got = trl.scale_probe_costs(c1, c2, n_units)
        assert got == jrl.scale_probe_costs(c1, c2, n_units)
        assert all(v >= 0 for v in got.values())
    # a negative delta is clamped: the base alone, at every depth
    assert trl.scale_probe_costs({"flops": 5.0}, {"flops": 3.0}, 10) == \
        {"flops": 5.0}


@pytest.mark.parametrize("link", ["nvlink", "net"])
@pytest.mark.parametrize("arch,shape", COMBOS)
def test_roofline_terms_match_the_reference_on_h100_constants(
        monkeypatch, arch, shape, link):
    """One link class: the reference's terms with its v5e constants
    swapped for the H100's (ICI for that class's link)."""
    jcfg, jshape, cfg, tshape = _pair(arch, shape)
    monkeypatch.setattr(jrl, "PEAK_FLOPS_BF16", tmesh.PEAK_FLOPS_BF16)
    monkeypatch.setattr(jrl, "HBM_BW", tmesh.HBM_BW)
    monkeypatch.setattr(jrl, "ICI_BW", trl.LINK_BW[link])
    window = tspecs.serve_window(cfg, tshape)
    rng = random.Random(hash((arch, shape, link)) % 1000)
    for chips in (256, 512):
        kw = dict(n_chips=chips, window=window,
                  hlo_flops=rng.uniform(1e12, 1e18),
                  hlo_bytes=rng.uniform(1e9, 1e13))
        link_bytes = rng.uniform(0, 1e12)
        want = jrl.roofline_terms(jcfg, jshape, link_bytes=link_bytes, **kw)
        got = trl.roofline_terms(cfg, tshape, link_bytes={link: link_bytes},
                                 **kw)
        for k, v in want.items():
            if isinstance(v, float):
                assert got[k] == pytest.approx(v, rel=1e-12, abs=0), k
            else:
                assert got[k] == v, k
        if link == "nvlink":                 # a number is NVLink's bytes
            assert trl.roofline_terms(cfg, tshape, link_bytes=link_bytes,
                                      **kw)["collective_s"] == \
                got["collective_s"]


def test_collective_terms_split_by_link_class():
    """Two classes: each class's bytes over its own bandwidth, summed."""
    cfg, tshape = get_config("yi-6b"), INPUT_SHAPES["train_4k"]
    t = trl.roofline_terms(cfg, tshape, n_chips=256, window=0,
                           hlo_flops=1e15, hlo_bytes=1e9,
                           link_bytes={"nvlink": 9e9, "net": 1e9})
    assert t["collective_s"] == pytest.approx(9e9 / 450e9 + 1e9 / 50e9,
                                              rel=1e-12)
    assert t["link_bytes_per_chip"] == 10e9


def test_collective_link_bytes_reads_dry_records_by_class():
    """The reference's ring formulas on a dry mesh's records, by HLO name
    and by link: ``model`` inside a node, ``data`` and ``pod`` across."""
    mesh = Mesh.dry({"pod": 2, "data": 32, "model": 8})
    recs = [("all_reduce", ("model",), 8, 1000),
            ("all_gather", ("data",), 32, 3200),
            ("reduce_scatter", ("data", "model"), 256, 10),
            ("all_to_all", ("model",), 8, 800),
            ("broadcast", ("pod",), 2, 50)]
    out = trl.collective_link_bytes(recs, mesh)
    want = {"all-reduce": 2 * 1000 * 7 / 8, "all-gather": 3200 * 31 / 32,
            "reduce-scatter": 10 * 255, "all-to-all": 800 * 7 / 8,
            "broadcast": 50.0}
    assert out["link_bytes"] == pytest.approx(want, rel=1e-15)
    assert out["counts"] == {k: 1 for k in want}
    assert out["total_link_bytes"] == pytest.approx(sum(want.values()))
    assert out["link_bytes_by_class"] == pytest.approx({
        "nvlink": want["all-reduce"] + want["all-to-all"],
        "net": want["all-gather"] + want["reduce-scatter"] +
        want["broadcast"]})


@pytest.mark.parametrize("shape,axes,want", [
    ({"data": 32, "model": 8}, ("model",), "nvlink"),
    ({"data": 32, "model": 8}, ("data",), "net"),
    ({"data": 32, "model": 8}, ("data", "model"), "net"),
    ({"data": 1, "model": 2}, ("model",), "nvlink"),
    ({"data": 2, "model": 1}, ("data",), "nvlink"),
    ({"data": 2, "model": 4}, ("data", "model"), "nvlink"),
    ({"data": 4, "model": 4}, ("data",), "net"),
    ({"pod": 2, "data": 32, "model": 8}, ("pod",), "net")])
def test_link_class(shape, axes, want):
    assert tmesh.link_class(shape, axes) == want


def test_constants_are_the_h100_sxm_data_sheet_rates():
    sys.path.insert(0, str(REPO))
    import chip_smoke
    hbm, _, bf16 = chip_smoke.CARD_RATES["SXM"]
    assert tmesh.HBM_BW == hbm == 3.35e12
    assert tmesh.PEAK_FLOPS_BF16 == bf16 == 989e12
    assert tmesh.NVLINK_BW == 450e9 and tmesh.NET_BW == 50e9
    assert tmesh.CARDS_PER_NODE == 8
    mesh = tmesh.make_production_mesh(nodes=32)
    assert mesh.shape == {"data": 32, "model": 8} and mesh.world == 256
    assert tmesh.make_production_mesh(multi_pod=True, nodes=32).world == 512
