"""The training window draws the same seps for every seed; the set-up
updates, which the reference checks, still draw theirs from the seed, and
one more update before the window decodes every row (sep 0)."""

import pytest
import torch

from pfnbench import run


@pytest.mark.parametrize("cell", ["fig3a_b100x1", "bnn_ref_b256"])
def test_every_seed_draws_the_same_window(cell, tiny_cell, monkeypatch):
    import pfn_tpu_torch.train.loop as loop

    make, drawn = loop.make_train_step, []

    def recording(*args, **kwargs):
        step = make(*args, **kwargs)

        def train_step(state):
            before = state.generator.get_state()
            out = step(state)
            drawn[-1].append((before, int(out["pos_cnt"].argmax())))
            return out

        return train_step

    monkeypatch.setattr(loop, "make_train_step", recording)
    wl, cfg = tiny_cell(cell)
    runs = []
    for seed in (2**31 + 3, 2**33 + 101):
        drawn.append([])
        result = run.run(cell, seed, 1.0, False, "cpu", workload_spec=wl, config=cfg)
        assert result["correct"], result["checks"]
        runs.append(drawn[-1])
    checked, window = 3, min(len(r) for r in runs)
    assert window > checked + 1
    assert not torch.equal(runs[0][0][0], runs[1][0][0])
    assert runs[0][checked][1] == runs[1][checked][1] == 0
    for (state0, sep0), (state1, sep1) in zip(runs[0][checked + 1:window], runs[1][checked + 1:window]):
        assert torch.equal(state0, state1) and sep0 == sep1
