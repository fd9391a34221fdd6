"""The differentiable collectives of ``repro_torch/distributed/
collectives.py`` on gloo ranks, against one-process sums.

Each rank (``tests/_torch_mesh_ranks.py:collectives_rank``; one spawn per
mesh: (1, 2) and (2, 1) on 2 ranks, (2, 2) on 4) runs every Function on
float32 draws from one seed and differentiates a loss through it:
``reduce_partial`` (*g*: the sum, the gradient passed on),
``enter_partial`` (*f*: the identity, the gradient summed over "model"),
``reduce_to_partial`` (both sums), ``gather_partial`` (the vocab gather:
each rank's slice of the gradient), ``fsdp_gather`` (the all-gather over
"data", its gradient reduce-scattered: each rank's loss is its own term)
and ``mean`` over "data".  Outputs and gradients within 1e-6 (the same
f32 sums in another order), the counters' kinds, calls and bytes exactly,
and off the autograd graph (serving, ``no_grad``) the in-place
``all_reduce``, the identity and ``gather_sum`` with the counts serving
always had.  Over an axis of size 1 nothing is issued or counted.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_mesh_ranks as ranks  # noqa: E402
from repro_torch.distributed.spawn import run_ranks  # noqa: E402

SHAPES = [(1, 2), (2, 1), (2, 2)]
SEED = 22
TOL = 1e-6
F32 = 4


@pytest.fixture(scope="module")
def runs():
    return {shape: run_ranks(ranks.collectives_rank, shape[0] * shape[1],
                             shape, SEED, timeout_s=240, threads=1)
            for shape in SHAPES}


def _draws(shape):
    """The rank function's draws, in its order."""
    d, m = shape
    rng = np.random.default_rng(SEED)
    x = rng.standard_normal((m, 3, 5)).astype(np.float32)
    c = rng.standard_normal((m, 5)).astype(np.float32)
    w = rng.standard_normal((3, 5)).astype(np.float32)
    full = rng.standard_normal((d, 6, 4)).astype(np.float32)
    wd = rng.standard_normal((d, d * 6, 4)).astype(np.float32)
    W = rng.standard_normal((m, 3, 5)).astype(np.float32)
    return x, c, w, full, wd, W


def _counts(calls, bytes_, **want):
    """Every kind's calls and bytes: ``want`` maps a kind to (calls,
    bytes); the kinds not named are zero."""
    for kind in calls:
        n, b = want.get(kind.replace("-", "_"), (0, 0))
        assert (calls[kind], bytes_[kind]) == (n, b), (kind, calls, bytes_)


def _close(a, b):
    np.testing.assert_allclose(a, b, rtol=0, atol=TOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_reduce_partial_sums_and_passes_the_gradient(runs, shape):
    x, _, w, *_ = _draws(shape)
    m = shape[1]
    ar = (1, x[0].size * F32) if m > 1 else (0, 0)
    for r in runs[shape]:
        res = r["reduce_partial"]
        _close(res["y"], x.sum(0))
        _close(res["grads"][0], w)
        _counts(*res["fwd"], all_reduce=ar)
        _counts(*res["all"], all_reduce=ar)


@pytest.mark.parametrize("shape", SHAPES)
def test_enter_partial_sums_the_gradient_over_model(runs, shape):
    x, c, w, *_ = _draws(shape)
    m = shape[1]
    one = x[0].size * F32
    for r in runs[shape]:
        res = r["enter_partial"]
        _close(res["grads"][0], w * c.sum(0))       # one process: x * sum c
        _counts(*res["fwd"], all_reduce=(1, one) if m > 1 else (0, 0))
        _counts(*res["all"], all_reduce=(2, 2 * one) if m > 1 else (0, 0))


@pytest.mark.parametrize("shape", SHAPES)
def test_reduce_to_partial_sums_both_ways(runs, shape):
    x, c, w, *_ = _draws(shape)
    m = shape[1]
    one = x[0].size * F32
    for r in runs[shape]:
        res = r["reduce_to_partial"]
        _close(res["grads"][0], w * c.sum(0))       # d/dx_r of (sum x) * sum c
        _counts(*res["fwd"], all_reduce=(2, 2 * one) if m > 1 else (0, 0))
        _counts(*res["all"], all_reduce=(3, 3 * one) if m > 1 else (0, 0))


@pytest.mark.parametrize("shape", SHAPES)
def test_gather_partial_hands_each_rank_its_slice(runs, shape):
    x, *_, W = _draws(shape)
    m = shape[1]
    ar = (1, m * x[0].size * F32) if m > 1 else (0, 0)
    for r in runs[shape]:
        mi = r["coords"][1]
        res = r["gather_partial"]
        _close(res["grads"][0], W[mi])
        _counts(*res["all"], all_reduce=ar)


@pytest.mark.parametrize("shape", SHAPES)
def test_fsdp_gather_and_its_reduce_scatter(runs, shape):
    *_, full, wd, _ = _draws(shape)
    d = shape[0]
    whole = full.reshape(d * 6, 4)
    for r in runs[shape]:
        di = r["coords"][0]
        res = r["fsdp_gather"]
        np.testing.assert_array_equal(res["y"], whole)   # zeros + one block
        # one process: the sum of every rank's loss, then rank di's rows
        _close(res["grads"][0], wd.sum(0)[di * 6:(di + 1) * 6])
        if d > 1:
            _counts(*res["fwd"], all_gather=(1, whole.size * F32))
            _counts(*res["all"], all_gather=(1, whole.size * F32),
                    reduce_scatter=(1, whole.size * F32 // d))
        else:
            _counts(*res["all"])


@pytest.mark.parametrize("shape", SHAPES)
def test_mean_over_data(runs, shape):
    d = shape[0]
    for r in runs[shape]:
        res = r["mean"]
        _close(res["y"], [np.mean(np.arange(d)), np.mean(2 * np.arange(d) + 1)])
        _counts(*res["all"], all_reduce=(1, 2 * F32) if d > 1 else (0, 0))


@pytest.mark.parametrize("shape", SHAPES)
def test_serving_calls_are_unchanged(runs, shape):
    x, *_ = _draws(shape)
    m = shape[1]
    one = x[0].size * F32
    for r in runs[shape]:
        s = r["serving"]
        assert s["reduce_in_place"] and s["to_partial_in_place"]
        assert s["enter_is_identity"]
        _close(s["reduced"], x.sum(0))
        np.testing.assert_array_equal(s["gathered"], x)
        _counts(*s["counts"],
                all_reduce=(3, (2 + m) * one) if m > 1 else (0, 0))
