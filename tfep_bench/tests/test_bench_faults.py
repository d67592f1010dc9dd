"""Runs with the timed path broken underneath come out not correct.

Each drives the rest of a run (set-up, the window, the reference's check)
on the CPU at a small size, with one fault planted in the program: a step
that leaves its state unchanged, half of the batch left out with the mean
taken over the rest, an answer altered where it is produced. The cells run
on one card, so there is no exchange between cards to leave out."""

import pytest

import small


def unchanged(opt):
    for group in opt.param_groups:
        group['lr'] = 0.0
        group['weight_decay'] = 0.0


def half_batch(tmap):
    step_fn = tmap.training_step_fn

    def training_step_fn(flow, batch):
        n = len(batch['positions'])
        half = {k: v[:n // 2] if hasattr(v, '__len__') and len(v) == n
                else v for k, v in batch.items()}
        return step_fn(flow, half)

    tmap.training_step_fn = training_step_fn


def altered_answer(tmap):
    """One answer of each batch altered by 0.1 (one in 64 here, one in
    131,072 at the cell's size)."""
    step_fn = tmap.training_step_fn

    def training_step_fn(flow, batch):
        loss, aux = step_fn(flow, batch)
        log_det_J = aux['log_det_J'].clone()
        log_det_J[5] += 0.1
        return loss, dict(aux, log_det_J=log_det_J)

    tmap.training_step_fn = training_step_fn


TRAINING = ['mixed_maf_helix32.train', 'cnf_egnn32.train']


@pytest.mark.parametrize('name', TRAINING)
def test_a_step_that_leaves_the_state_unchanged(name):
    result, rows, _ = small.run(small.cell(name),
                                fault=dict(optimizer=unchanged))
    assert result['correct'] is False
    assert dict((n, v) for n, v, _ in rows)['update'] == pytest.approx(1.0)


@pytest.mark.parametrize('name', TRAINING)
def test_half_of_the_batch_left_out(name):
    result, _, _ = small.run(small.cell(name), fault=dict(map=half_batch))
    assert result['correct'] is False


def test_an_answer_altered_where_it_is_produced():
    result, rows, _ = small.run(small.cell('mixed_maf_helix32.eval'),
                                fault=dict(map=altered_answer))
    assert result['correct'] is False
    assert dict((n, v) for n, v, _ in rows)['log_det_J_max'] == \
        pytest.approx(0.1)


@pytest.mark.parametrize('name', TRAINING + ['mixed_maf_helix32.eval'])
def test_the_unbroken_run_is_correct(name):
    assert small.run(small.cell(name))[0]['correct'] is True
