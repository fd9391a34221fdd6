"""The check catches a broken timed path: a CPU run of each cell at its
small size, the look for a chip skipped, with one fault planted under the
window, comes out not correct; the same run unbroken comes out correct.
Faults: a decode step that leaves its state unchanged (the K/V row not
written), half of each group's requests left
out, and a token altered where the engine produces it.  A one-chip cell
has no exchange between chips to leave out."""
import numpy as np
import pytest

import pb_small

CELLS = pb_small.CELLS


def _state_unchanged(monkeypatch, cell):
    from repro_torch.models import attention
    monkeypatch.setattr(attention, "cache_update",
                        lambda cache, new, index, shard=None: cache)


def _half_left_out(monkeypatch, cell):
    from repro_torch.serving.engine import ContinuousServingEngine
    run = ContinuousServingEngine.run

    def half(self, requests, on_tokens=None):
        outs, st = run(self, requests, on_tokens=on_tokens)
        return outs[: len(outs) // 2], st
    monkeypatch.setattr(ContinuousServingEngine, "run", half)


def _token_altered(monkeypatch, cell):
    from repro_torch.serving.engine import ContinuousServingEngine
    consume = ContinuousServingEngine._consume_block
    V = pb_small.CONFIGS[cell]["vocab_size"]

    def altered(self, block, slot_states, K, step_no):
        return consume(self, (np.asarray(block) + 1) % V, slot_states, K,
                       step_no)
    monkeypatch.setattr(ContinuousServingEngine, "_consume_block", altered)


FAULTS = {"state_unchanged": _state_unchanged,
          "half_left_out": _half_left_out,
          "token_altered": _token_altered}


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(root, cell):
    res = pb_small.run(root, cell)
    assert res["correct"], res["compared"]
    assert res["failed"] == 0 and res["attempted"] > 0


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_caught(root, cell, fault, monkeypatch):
    FAULTS[fault](monkeypatch, cell)
    res = pb_small.run(root, cell)
    assert not res["correct"], res["compared"]
