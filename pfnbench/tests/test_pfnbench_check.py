"""The comparison that decides ``correct`` fails what it has to fail.

On the CPU at a test's size: each cell's control (the reference one
precision below the configuration's, put in the program's place) reads
outside the cell's limits, and a run of the harness with the port's timed
path broken underneath comes out not correct, once for each fault the cell
can have: a step that returns its state unchanged, half of the batch left
out with the mean taken over the rest, an answer altered where it is
produced. The unbroken run of each comes out correct. The ``card`` tests
read the control at the cells' own sizes."""

import pytest
import torch

from pfnbench import calibrate, check, run, spec

TRAIN = ["fig3a_recipe_b4x25", "bnn_ref_b256", "fig3a_b100x1"]
SEED = 2**31 + 77


def _run(cell, tiny_cell):
    wl, cfg = tiny_cell(cell)
    return run.run(cell, SEED, 0.2, False, "cpu", workload_spec=wl, config=cfg)


@pytest.mark.parametrize("cell", TRAIN + ["fig3a_score_b32"])
def test_the_unbroken_run_is_correct(cell, tiny_cell):
    result = _run(cell, tiny_cell)
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("cell", TRAIN + ["fig3a_score_b32"])
def test_the_control_is_not_correct(cell, tiny_cell):
    wl, cfg = tiny_cell(cell)
    upper = (calibrate.train_upper if wl["kind"] == "train" else calibrate.score_upper)(cfg, wl, SEED, "cpu")
    assert not check.judge(upper["control"], wl["limits"])[0], upper["control"]


@pytest.mark.parametrize("cell", TRAIN)
def test_a_step_that_leaves_the_state_unchanged(cell, tiny_cell, monkeypatch):
    from pfn_tpu_torch.train import loop

    def frozen(state, schedule):
        return torch.nn.utils.get_total_norm([p.grad for p in state.model.parameters()])

    monkeypatch.setattr(loop, "_clip_and_step", frozen)
    result = _run(cell, tiny_cell)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("cell", TRAIN)
def test_half_the_batch_left_out(cell, tiny_cell, monkeypatch):
    from pfn_tpu_torch.train import loop

    whole = loop._loss_terms

    def half(criterion, out, target_y, sep, mesh):
        n = out.shape[0] // 2
        return whole(criterion, out[:n], target_y[:n], sep, mesh)

    monkeypatch.setattr(loop, "_loss_terms", half)
    result = _run(cell, tiny_cell)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("cell", TRAIN)
def test_a_datum_altered_where_the_prior_draws_it(cell, tiny_cell, monkeypatch):
    from pfn_tpu_torch.evals.comparison import BayesianNNModel
    from pfn_tpu_torch.priors import gp

    grid = gp.gp_sample_paths_grid

    def gp_altered(*args, **kwargs):
        x, y = grid(*args, **kwargs)
        y = y.clone()
        y[0, 0] += 0.5
        return x, y

    draw = BayesianNNModel._draw_data

    def bnn_altered(self, generator, params, shape):
        x, y = draw(self, generator, params, shape)
        y = y.clone()
        y.view(-1)[0] = 1.0 - y.view(-1)[0]
        return x, y

    monkeypatch.setattr(gp, "gp_sample_paths_grid", gp_altered)
    monkeypatch.setattr(BayesianNNModel, "_draw_data", bnn_altered)
    result = _run(cell, tiny_cell)
    assert not result["correct"], result["checks"]


def test_an_answer_altered_where_it_is_produced(tiny_cell, monkeypatch):
    from pfn_tpu_torch.evals import harness

    predict = harness.pfn_predict

    def altered(model, x, y, sep, rows=None):
        out = predict(model, x, y, sep, rows=rows).clone()
        row = sep if rows is None else sep - rows[0]
        out[0, row] = out[1, row]
        return out

    monkeypatch.setattr(harness, "pfn_predict", altered)
    result = _run("fig3a_score_b32", tiny_cell)
    assert not result["correct"], result["checks"]


@pytest.mark.card
@pytest.mark.parametrize("cell", TRAIN + ["fig3a_score_b32"])
def test_the_control_at_the_cells_size(cell, card):
    wl = spec.workload(cell)
    cfg = spec.config(wl["config"])
    for seed in (SEED, SEED + 1, SEED + 2):
        upper = (calibrate.train_upper if wl["kind"] == "train" else calibrate.score_upper)(cfg, wl, seed, card)
        assert not check.judge(upper["control"], wl["limits"])[0], upper["control"]


def test_the_reference_takes_only_labels_that_rounding_decides():
    program = [{"x": torch.zeros(1, 3, 1), "y": torch.tensor([[1.0, 0.0, 1.0]])}]
    reference = [{"x": torch.zeros(1, 3, 1, dtype=torch.float64), "y": torch.tensor([[0.0, 1.0, 1.0]]).double(),
                  "margin": torch.tensor([[1e-7, 0.3, 1e-7]]).double()}]
    assert check.adopt_ambiguous_labels(program, reference) == 1
    assert reference[0]["y"].tolist() == [[1.0, 1.0, 1.0]]  # the second label stays the reference's
    assert check.batch_gap(program, reference) == 1.0
