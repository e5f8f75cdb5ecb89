"""The control at a size a CPU test holds: the program one precision
below the cell's (float32 for float64) fails the cell's limits, and the
sound float64 run passes them, through the whole run but the look for a
card (``run_cell`` on the CPU).  On the card the control is read at the
cell's own size with ``portbench/calibrate.py --dtype float32``."""

SEED = 2 ** 31 + 4242


def test_sound_run_is_correct(tiny_bench):
    from portbench.harness import run_cell

    result, checks, _ = run_cell(tiny_bench, "table2_c24_f64", SEED, 0.1,
                                 False, device="cpu")
    assert result["correct"], checks
    assert result["attempted"] == 3 and result["failed"] == 0
    assert {"equilibria_per_s", "sweep_p90_s", "setup_s"} <= set(
        result["metrics"])


def test_control_is_not_correct(tiny_bench):
    from portbench.harness import run_cell

    result, checks, _ = run_cell(tiny_bench, "table2_c24_f64", SEED, 0.1,
                                 False, device="cpu",
                                 dtype_name="float32")
    assert not result["correct"], checks
