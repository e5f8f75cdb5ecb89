"""Each fault the cells can have, planted under a whole run on the CPU
(``run_cell`` skips only the look for a card), makes ``correct`` false:
a step that returns its state unchanged, half of the batch left out
(filled with the mean of the rest, or returned with a failing status),
an answer altered where it is produced.  The cells run on one card, so no
exchange between cards can be left out."""

import numpy as np
import torch

SEED = 2 ** 31 + 777


def _run(bench, sweep_fn=None):
    from portbench.harness import run_cell

    result, checks, _ = run_cell(bench, "table2_c24_f64", SEED, 0.1, False,
                                 device="cpu", sweep_fn=sweep_fn)
    return result, checks


def test_distribution_step_returns_its_state(tiny_bench, monkeypatch):
    from aiyagari_hark_tpu_torch.models import household

    def unchanged(idx, weight, P, dist0, tol, max_iter, accel_every):
        lanes = dist0.shape[0]
        return (dist0, torch.ones(lanes, dtype=torch.int32),
                torch.zeros(lanes, dtype=dist0.dtype))

    monkeypatch.setattr(household, "stationary_lottery_grid", unchanged)
    result, checks = _run(tiny_bench)
    assert not result["correct"], checks


def test_half_the_batch_left_out(tiny_bench):
    from aiyagari_hark_tpu_torch.parallel.sweep import run_sweep

    def half(cells, dtype, device, kwargs):
        keep = (len(cells) + 1) // 2
        res = run_sweep("aiyagari", cells=cells[:keep], dtype=dtype,
                        device=device, **kwargs)
        # the left-out cells take the mean of the solved ones' rows
        fill = np.repeat(res.rows.mean(axis=0, keepdims=True),
                         len(cells) - keep, axis=0)
        res.rows = np.concatenate([res.rows, fill])
        res.status = np.concatenate([res.status,
                                     np.zeros(len(fill), dtype=np.int64)])
        res.cells = np.asarray(cells)
        return res

    result, checks = _run(tiny_bench, half)
    assert not result["correct"], checks


def test_half_the_batch_returned_failed(tiny_bench):
    from aiyagari_hark_tpu_torch.parallel.sweep import run_sweep

    def half(cells, dtype, device, kwargs):
        keep = (len(cells) + 1) // 2
        res = run_sweep("aiyagari", cells=cells[:keep], dtype=dtype,
                        device=device, **kwargs)
        # the left-out cells come back with a failing status (MAX_ITER)
        fill = np.repeat(res.rows[:1], len(cells) - keep, axis=0)
        res.rows = np.concatenate([res.rows, fill])
        res.status = np.concatenate([res.status,
                                     np.full(len(fill), 2, dtype=np.int64)])
        res.cells = np.asarray(cells)
        assert len(res.failed_cells()) == len(fill)
        return res

    result, checks = _run(tiny_bench, half)
    assert result["failed"] > 0
    assert checks["failed_cells"][0] == result["failed"]
    assert checks["r_gap_bp"][0] <= checks["r_gap_bp"][1]
    assert not result["correct"], checks


def test_answer_altered_where_produced(tiny_bench, monkeypatch):
    from aiyagari_hark_tpu_torch.parallel import sweep

    real = sweep.pack_rows

    def altered(values):
        rows = real(values)
        rows[0, 0] += 2e-4          # the first cell's r*, by 2 bp
        return rows

    monkeypatch.setattr(sweep, "pack_rows", altered)
    result, checks = _run(tiny_bench)
    assert not result["correct"], checks
