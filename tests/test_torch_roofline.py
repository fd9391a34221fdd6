"""``repro_torch.launch.roofline`` against the JAX package's
``repro.launch.roofline`` (safe to import here: it sets no device count):
``model_flops`` of every (config × shape) and ``MODE_TRIPS`` /
``_block_kind`` equal; ``RooflineTerms.row()`` with JAX's keys, its terms
on the H100's rates (``core/profiler.py``); the terms of a dry-run
result; ``block_cost`` and the dry run's ``layer_costs`` breakdown.
Exact comparisons (the numbers are integers or one division)."""
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.configs.shapes import INPUT_SHAPES as JSHAPES  # noqa: E402
from repro.launch import roofline as jroofline  # noqa: E402
from repro_torch.configs.base import get_config, mesh_configs, reduced  # noqa: E402
from repro_torch.configs.shapes import INPUT_SHAPES, InputShape  # noqa: E402
from repro_torch.core import profiler  # noqa: E402
from repro_torch.launch import dryrun, roofline  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402

import numpy as np  # noqa: E402

ARCHS = mesh_configs()          # the JAX package's twins


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_and_trips_match_jax(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    for name, shape in INPUT_SHAPES.items():
        assert roofline.model_flops(cfg, shape) == \
            jroofline.model_flops(jcfg, JSHAPES[name]), name
        assert roofline.MODE_TRIPS[shape.mode](cfg) == \
            jroofline.MODE_TRIPS[shape.mode](jcfg)
    assert roofline._block_kind(cfg) == jroofline._block_kind(jcfg)


def _terms(**kw):
    base = dict(arch="a", shape="s", mode="decode", chips=4,
                flops_per_chip=2e12, bytes_per_chip=7e9, coll_per_chip=9e8,
                model_flops=4e12)
    base.update(kw)
    return base


def test_row_keys_match_jax():
    got = roofline.RooflineTerms(**_terms()).row()
    want = jroofline.RooflineTerms(**_terms()).row()
    assert list(got) == list(want)
    for k in ("arch", "shape", "mode", "model_flops", "useful_flops_ratio"):
        assert got[k] == want[k]


def test_terms_on_h100_rates():
    t = roofline.RooflineTerms(**_terms())
    assert t.t_compute == 2e12 / profiler.H100_PEAK_FLOPS_BF16
    assert t.t_memory == 7e9 / profiler.H100_HBM_BW
    assert t.t_collective == 9e8 / profiler.H100_NVLINK_BW
    assert (profiler.H100_PEAK_FLOPS_BF16, profiler.H100_HBM_BW,
            profiler.H100_NVLINK_BW) == (989e12, 3.35e12, 450e9)
    assert t.dominant == "memory"
    assert t.useful_flops_ratio == 4e12 / (4 * 2e12)


def test_terms_of_a_dryrun_result():
    res = dryrun.run_dryrun("llama3.2-1b", "decode_32k", verbose=False)
    t = roofline.terms(res)
    assert t.chips == 256 and t.mode == "decode"
    assert t.flops_per_chip == res["flops"]
    assert t.bytes_per_chip == res["bytes_accessed"]
    assert t.coll_per_chip == res["collective_bytes"]["total"]
    assert t.model_flops == roofline.model_flops(
        get_config("llama3.2-1b"), INPUT_SHAPES["decode_32k"])
    # a decode step reads every rank's weights and its cache block
    assert t.dominant == "memory"


def _view(shape):
    axes = ("pod", "data", "model")[-len(shape):]
    return Mesh(np.arange(int(np.prod(shape))).reshape(shape), axes,
                view=True)


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "seamless-m4t-medium",
                                  "moonshot-v1-16b-a3b"])
def test_layer_costs_breakdown(arch):
    """Each block's trips and costs; the hybrid adds its shared attention
    block, the audio model its encoder (train and prefill)."""
    cfg = reduced(get_config(arch))
    shape = InputShape("t", 32, 4, "train")
    out = dryrun.layer_costs(cfg, shape, _view((2, 2)))
    kinds = [b["kind"] for b in out["bodies"]]
    want = ["layer"] + {"hybrid": ["shared_attn"],
                        "audio": ["encoder"]}.get(cfg.family, [])
    assert kinds == want
    for b in out["bodies"]:
        assert b["flops"] > 0 and b["bytes"] > 0
    assert out["bodies"][0]["trips"] == cfg.num_layers
    # train counts forward + backward (at least the weights' gradients, a
    # forward's products) + one more forward
    fwd = roofline.block_cost(cfg, InputShape("p", 32, 4, "prefill"),
                              _view((2, 2)))
    assert out["bodies"][0]["flops"] >= 3 * fwd["flops"]
