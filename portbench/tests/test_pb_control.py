"""The control: the reference computed with fp8 products, put in the
program's place, comes out not correct by the harness's own verdict,
where the served tokens of the same run stay under the limit, at the
cells' small sizes on three seeds (on the chip, the same runs at the
cells' own sizes are ``portbench/readings.py --control-seeds``)."""
import pytest

import pb_small


@pytest.mark.parametrize("cell", pb_small.CELLS)
def test_control_fails_the_limit_the_program_meets(root, cell):
    limit = pb_small.LIMITS["logit_gap"]
    for seed in (11, 2**31 + 3, 987654321987):
        res = pb_small.run(root, cell, seed=seed, control=True)
        assert not res["correct"], res["compared"]
        assert res["compared"]["logit_gap"]["value"] > 3 * limit
        assert res["served_logit_gap"] <= limit
